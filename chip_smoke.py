#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port (graal_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

On a host with several cards, ``python3 chip_smoke.py --cards`` runs
instead the across-cards checks (``phase_cards``): an NCCL world of one
rank a card, and the CLI under ``torchrun`` against one process.
``python3 chip_smoke.py --top-tiers`` runs only the build, the 100k
set-up and the phases of the top tiers (5, 8b, 11e, 11g, 11h, 3d, 3c, 3e,
3g and 3i at f_max 16,384, 5c), then the 20k repeat set-up and F1 / F2 at
R = 8,192 (3f).

Every sampler cycle (EM, delta EM, tempered, MTM / MH dense and delta)
and every ScaleRunner cycle end runs as the entry points run it: a
captured CUDA graph replayed once a step (``graal_tpu_torch.core.graphs``).
Each wrapper counts its launches on the card (``graal_tpu_torch.ops.counts``):
C1 / C2 and D3 add one to their key's counter themselves, every other
wrapper with an add beside the launch; the graph captures either with
the launch, so a replay advances the counts the phases check
(``n_launches``; B1's and B3's ``launch_shapes`` by (B, K)): phases 7g
and 7h hold them, and the graphs' results, to the same cycles run
eagerly.

Phases, in order; any failure raises and exits non-zero. Every kernel is
timed at the shapes its path gives it twice, with CUDA events around many
calls: as called ("ms", which at a few microseconds a call times the
host's enqueue) and on the device alone ("device_ms": the calls queued
behind a spin kernel that outlasts their enqueue, so they run back to
back). No time is taken from torch.profiler: its kernel durations drift
against the events' in a long process. A kernel's bound is the least time
the card could take for the same work, max(bytes / 3.35 TB/s, FP32
operations / 67 TFLOP/s, special-function operations /
(132 x 16 x the SM's maximum clock)), from this run's inputs: 6 FP32
operations per cell a candidate evaluates and, per same-contig pair inside
(0, d_max) (counted on the card), 10 more and 3 special-function ones (B3:
one more per data cell with more than one active copy pair and ob > 0); the
scorers read the strict upper triangle of their observed planes only. B1
counts what its inputs need: a trans cell's term does not depend on the
genome, so the sum of the trans form over every cell is one constant per
scorer, and a score is that constant plus, over the same-contig pairs
inside (0, d_max), the cis term less the trans term; so B1 counts one cell
and one such pair for each of them (16 FP32, 3 special-function
operations), the observed cells of those pairs once, the vectors, factors
and scores. B2 counts what its classes of (half tile, candidate) need
(``mini_bound``): the cell operations of the band pairs only, 576 FP32
for a band-free pair (its 96 rows and columns), nothing for an empty one,
and the observed cells of the half tiles some candidate's class reads. B4
moves bytes only: the CSR entries of the rows read, the keys and the grid
written. "share" is the bound over the device time.

1. Device: refuse to run without CUDA; print the card (nvidia-smi name and
   power limit), torch's and nvcc's versions.
2. Build: compile every kernel library (graal_tpu_torch/csrc/*.cu, sm_90a),
   one nvcc process each, all started together; print the build times and
   the compiler's register / spill report. Then the 100k set-up (phase 5's
   problem).
3c. Catalogue kernels C1 (em_catalogue, the EM catalogue) and C2
   (mh_catalogue, the MH one; csrc/candidates.cu) against their plain
   torch versions, all 11 fields bit for bit: the EM step's call (one
   genome over its neighbour slots, f_a 0-d) at 8 fragments each of the
   flagship's true genome, its exploded start and a circularised contig;
   the repeat table active, with every other copy inactive and with a
   circularised contig (f_a on copies: swap activity, mode 8); 4 chains'
   rows (one genome a (chain, neighbour), each chain's maximum); MTM / MH
   passes on entry.problem_jump_table's neighbour sets; ROADMAP section
   C's collision input (candidate 10 relabelled 4, circular); the delta
   engine's mini-states at R = 1,024 (M = 5) and R = 16,384 (4 chains,
   M = 20) with the whole genome's maximum, with and without the base
   slot; the edges of the kernels' partition (one cluster of K blocks a
   genome, ``ops/candidates_cuda.plan``): genomes of n = 1, 257 (a second
   block of one fragment) and 2,049 (8 blocks, block 0 looping to a
   second chunk of one fragment) cut from the 100k truth, and 7 rows of
   the 257 one with the whole state's maximum (each cluster reads every
   row). Each shape also on CAT_PAIRS random (f_a, f_b) pairs, one in ten
   with f_a == f_b, the maximum taken from the state, given as an int and
   as a tensor in turn. The launches the kernels counted on the card
   equal the calls made, by kind. Timed against the plain versions (device
   ms of both) at the EM step's shape (B = 5, n = 384), the tempered
   chains' (20 rows), an MTM pass's (B = 7) and the delta shapes (base
   slot on), with the bound: the state read once, the (11, B, 13 or 14,
   n) int32 output written once. ``--top-tiers`` repeats the R = 16,384
   shape (B = 20, n = 16,384) alone, with its counts, and times C1 there.
3d. The step kernels (csrc/step.cu): the step's head (step_head_kernel:
   D2's neighbour draw with D1's nuisance proposal beside it, one launch;
   either part alone), D3 (the selection and commit:
   select_commit_dense_kernel, select_commit_delta_kernel) and the step's
   tail (step_tail_kernel: the l_t select on D3's score, D1's Metropolis
   test and the cycle metrics n_contigs / mean_len, each part optional)
   against their plain torch versions (core/mcmc.py, core/delta.py
   ``*_plain``) on each EM-family path's own inputs, STEP_DRAWS random
   draws a shape (after the 20k repeat set-up): the dense flagship (B =
   65) and dense repeat (B = 130) paths (the true genome and its exploded
   start, half the fragments repeat copies: the head with both parts, the
   tail with all three), 4 tempered chains (the draw alone; the tail's
   select and metrics, per-chain f_t), a copy-dense table's draw (15
   extra copies of a bin, m = 80; and with 40 partners a bin: the keys
   ranked through shared memory, 656 candidate entries), the 100k delta
   path (M = 5), its 4
   chains (M = 20) and the 20k repeat twin (M = 10) (the draw alone), the
   runner's cycle end (4 chains' own parameters, the d_max cap: the
   proposal alone, the test alone), and the tail at CAT_EDGE_N's genome
   sizes (n = 1, 257, 2,049: its block reduction's edges); D3's cluster
   (``ops/step_cuda.select_cluster``) at its edges: dense commits of n =
   1, 257 and 2,049 fragments (K = 1, 2 and 8, block 0 looping) on random
   scores, and the 100k step at bucket 4,096 on the tiered cut (K = 8, two
   rows a thread). The head's ids and valid masks, test parameters,
   in_support and the dense scorers' parameter row, the tail's l_t,
   parameters, accept, n_contigs and mean_len bit for bit (NaN equal to
   NaN; a quarter of the scores -inf or NaN); D3's drawn slot equal to the
   plain version's except where the categorical draw decides and its two
   best keys lie within SLOT_ULPS ulps of the best (the normaliser is
   summed in another order; either of the two passes there, and those
   draws are counted and printed), and wherever it agrees the new state
   (dense) or the written rows (delta), score / d_sel, op, fb and n_over
   bit for bit; a quarter of the calls with f_a blacklisted and, on the
   delta paths, a quarter with every slot overflowing; each chain's valid
   member rows distinct on the real steps' inputs (the delta commit's
   contract); the launches every step kernel counted on the card equal to
   the calls made, by kind. Each kernel timed at each path's shape as 3c
   times C1 (device ms; the plain version's as graph replays) beside its
   bound. Phases 4, 4b, 7 and 7b count one head and one D3 launch a step
   (and one tail a step on the dense paths); 7g / 7h hold graph == eager
   with the step kernels' launches equal by key.
3e. MTM / MH step kernels E1 (the neighbour set, its discard mask, the
   largest contig id and the contig count: mtm_set_kernel), E2 (the
   forward weights, the slot draw and g*: mtm_draw_kernel) and E3 (the
   backward weights, the acceptance and the commit: mtm_accept_kernel;
   csrc/mtm.cu) against their plain versions (core/mtm.py ``*_plain``)
   on MOVE_DRAWS random draws a shape over MOVE_PIVOTS pivots (each pivot's
   forward pass scored once by the path's scorer, the backward pass once a
   drawn slot): the dense flagship's MTM from the truth, MH from the
   exploded start and corrected MTM (B1 at B = 91, the flagship's jump
   table, delta 5), MH with a circularised contig at the pivot, the dense
   repeat twin's MTM (B3, pivots half among the copies), the 100k delta MTM
   at f_max F_MAX and its corrected twin, and the 20k repeat delta MH (the
   repeat engine v2); 10c adds the CLI dataset's level 1 (n = 972) and
   ``--top-tiers`` the 100k truth at bucket 16,384. E1's outputs bit for
   bit in both modes; E2's drawn slot equal to the plain version's except
   where its two best keys lie within MOVE_ULPS ulps (either passes, the
   draw is counted and not compared further), then f*, ll*, the forward
   maximum, ok and g*'s 11 fields bit for bit; E3's acceptance equal except
   where min(ratio, 1) lies within MOVE_ULPS ulps of u or u lies between
   the two versions' ratios (the weight sums are summed in another order;
   counted), then the new state, l_t and n_contigs bit for bit, and a
   rejected delta step leaves the state it wrote equal to its input. One
   draw in eight discards every forward slot, one in eight every backward
   slot, one in eight of a delta shape has every neighbour overflow. Each
   kernel timed at each shape (device ms; the plain version's as graph
   replays) beside its bound. Phases 7h (graph == eager by key), 10a, 10e
   and 11h count two E1, one E2 and one E3 launch a step.
3f. Copy-correction kernels F1 (the routing and frozen terms:
   corr_frozen_kernel) and F2 (the per-genome sums and the delta:
   corr_sums_kernel; csrc/repeat_corr.cu) against their plain version
   (core/delta_repeats.py ``corrections_plain``) on CORR_DRAWS random
   (f_a, neighbour) slots a shape, f_a half among repeat copies and
   originals of duplicated bins, the neighbours as each path draws them
   (D2's draw; E1's neighbour set for MH): the 20k repeat delta EM step
   (m = 10), 4 chains (M = 40), 3 chains at bucket 4,096 (M = 30), the
   20k repeat delta MH step (M = 7), the 12-dup exactness twin and the
   20k problem with 2 to 12 copies a duplicated bin (c_max 12; the others
   have 2) and the 20k truth at bucket 8,192 (valid rows above 4,096;
   ``--top-tiers`` times it again). Each shape's line gives its table's
   c_max and its most valid rows. corr and cross within rtol CORR_RTOL (atol
   CORR_ATOL), dll within max(DLL_ATOL, one f32 ulp): every f32 term is
   the plain version's bit for bit (both fold a bin's copies left to
   right), only the f64 sums' order differs (F2 folds in its fixed order,
   torch in its own); each shape's line says whether this run's draws came
   out bit-identical to the plain version or only within the tolerances.
   Each kernel timed at each shape (F1 and F2 alone from one argument
   block, the pair through the wrapper; device ms; the plain version's as
   graph replays) beside its bound, counted from the call's records
   (``corr_bound``); F2's line names the layout its wrapper picked
   (``repeat_corr_cuda.sums_plan``). The launches F1 and F2 counted themselves on
   the card equal the wrapper's calls counted on the host
   (``check_counted``; the timed launches alone on a scratch counter).
   Phases 7b, 7g / 7h (the repeat cycles), 8a, 11b and 9f's ``scale
   --allow-repeats`` count one F1 and one F2 launch a scoring call; the
   repeat-free paths none.
3g. Member-row kernels G1 (the counts: rows_counts_kernel), G2 (the
   ordered write: rows_write_kernel) and G3 (the mini-state gather:
   rows_gather_kernel; csrc/rows.cu) against their plain versions
   (core/delta.py ``extract_rows_union_plain``, ``extract_rows_each_plain``
   with the chains' ``id_c.amax(-1)``, ``gather_mini_plain``) on
   ROWS_DRAWS random (chain, slot) draws a shape, fA and the neighbours as
   each path draws them, one call in eight with fA among its own
   neighbours and one in eight with two slots on one contig: the 100k
   delta EM step (union, M = 5, f_max F_MAX), its 4 chains (M = 20), the
   100k delta MTM pass (each, m = 7, E1's neighbour set), the 20k repeat
   step (each, M = 10) and 4 repeat chains (M = 40); the edge shapes: the
   100k truth (every pair above f_max), f_max = n on an EDGE_N-fragment
   cut of the repeat genome (each and union) and u_cap = n (union at
   bucket 4,096 on the 20k genome); the repeat delta EM step at m = 80
   slots (the 20k problem with 2 to ROW_COPIES copies a duplicated bin),
   then that step driven on the card at the repeat exactness twin's
   fragments, re-anchored, one G set and one F1 + F2 pair a step, and at m
   = 320 slots (2 to SLOT_COPIES copies, drawn as D2 draws them); 9d adds
   the CLI dataset's bucket (f_max 64, R = 192) on its run's final genome
   and ``--top-tiers`` f_max 16,384 for 4 chains of the truth (M = 20).
   rows (padding included), valid,
   overflow, max_id and the 11 mini-state fields bit for bit. Each kernel
   timed (device ms; the plain versions' as graph replays) beside its
   bound in bytes (``rows_bound``), and torch.topk on the plain version's
   genome-length key alone as the library call. The launches G1-G3
   counted themselves on the card equal the wrapper's calls counted on the
   host (``check_counted``). Phases 4 and 4b count no G launch; 7, 7b,
   7g, 7h (the delta cycles and run_mtm), 8, 8a, 8b, 9d, 9e, 9f's ``scale
   --allow-repeats``, 11a, 11b, 11e, 11g and 11h count one
   G1 + G2 pair and one G3 launch a scoring call (two a delta MTM / MH
   step).
   G1's scratch (each contig's counts at its first place, the chunk
   maxima, the sorted keys) is also held to a plain count on the card at
   every shape.
3h. The dense scorers' vector kernel H1 (vectors_kernel) and the captured
   cycle's kernels H2 (scan_load_kernel: a call's first load) and H3
   (scan_store_kernel: a step's stores and the next step's loads in one
   launch; csrc/vectors.cu, csrc/scan_io.cu). H1 against its plain
   versions (the scorer's ``vectors_plain`` and ``params_vector``, torch
   on the card) at every dense path's shape: the flagship EM step (B = 65)
   and its nuisance call (B = 1, an ``x[None]`` view), the dense repeat
   step (B3, B = 130, with the copy-order ``a`` column, and B = 1), 4
   tempered chains (B = 260), an MTM pass at K = 972 (B = 91), K = 2,901
   (B = 65) and K = 6,000 (B = 13): mid, idc, circ, stot, a and the
   parameter row bit for bit, each shape timed (H1 alone from one argument
   block; the plain version's ms as called and as graph replays) beside
   its bound in bytes. H2 / H3 against the plain sequence on the trees
   every sampler's Scan builds (dense EM, tempered, dense MTM and MH, the
   100k delta EM cycle and its 4 chains, the 20k repeat delta cycle, the
   100k delta MTM and 20k repeat delta MH cycles, the runner's cycle end):
   each cycle run eagerly on the card for its first call (whose steps fill
   the buffers' capacity), the call's first load checked against
   ``scan_load_plain``, and every step, the last included, against
   ``scan_store_plain`` then ``scan_load_plain`` of the next row (none
   past the capacity) done into copies of the scan's buffers, index and
   slots, every byte compared; one H2 launch a call and one H3 launch a
   step (none cut); each tree's first step timed: H3 alone from its
   tables, H2 alone, the same step's work as the separate store-only and
   load-only launches of before, the plain versions as called and as graph
   replays, and ``torch._foreach_copy_`` on the same carry leaves (the one
   PyTorch call for those copies), beside the bound of the bytes copied
   (the timed launches counted on scratch counters, their index written to
   a scratch cell). The three kernels count their own launches on the
   card (block 0's thread 0): the counts equal the calls made to H1's
   wrapper and the launches H2 / H3's made (``check_counted``). Phases 4,
   4b, 7, 7b, 7g and 7h count one H3 launch a captured step, one H2 launch
   a call with per-step inputs and one H1 launch a dense scoring call
   (graph == eager by key).
3i. The delta engine's input kernels I1 (the slots' lf_a, lf_b, max_id
   and parameter rows: delta_slots_kernel) and I2 (the sub-row vectors of
   each slot's 14 genomes, B4's keys and the repeat engine's act / circ /
   accu_sub: delta_vectors_kernel; csrc/delta_inputs.cu) against their
   plain versions (core/delta.py ``slot_inputs_plain``,
   ``sub_vectors_plain``, torch on the card) on INPUTS_DRAWS random (chain,
   slot) draws at every delta path's shape, each call's rows, mini-states
   and catalogue made on the card as the path makes them: the 100k delta
   EM step (union, M = 5, f_max 1,024), its 4 chains with their own
   parameters (M = 20), the 100k delta MTM pass (M = 7, C2's catalogue),
   the 20k repeat step (M = 10, key_of) and its 4 chains (M = 40), and the
   repeat step at m = 80 on 2-16 copies a bin; 9d adds the CLI dataset's
   bucket (f_max 64, 1 to 3 sub rows a fragment) and ``--top-tiers`` f_max
   16,384 (4 chains, M = 20). Every output byte compared (bools as bytes);
   each shape timed (I1 and I2 alone from one argument block; the plain
   versions as called and as graph replays) beside its bound in bytes.
   The launches I1 and I2 counted themselves on the card equal the
   wrapper's calls counted on the host (``check_counted``; the timed
   launches alone on a scratch counter).
   Every delta path (7, 7b, 7g, 7h, 8, 8a, 8b, 9d-9f, 11a, 11b, 11e, 11g,
   run_mtm) counts one I1 and one I2 launch a scoring call beside its G1-G3
   launches (graph == eager by key).
3. Dense kernel B1 (ll_dense) vs plain: the dense scorer kernel against its
   plain torch version on the same inputs, rtol 1e-4 (bench.py's
   standard), at the flagship K = 1,152 on 65-candidate batches built on
   the true genome, on its exploded start and on a state with a
   circularised contig; at B = 1 (the nuisance shape); and at K = 6,000 on
   a 13-candidate batch. Each candidate's score must be bit-identical alone
   and in any batch. The kernel is also held to the direct-pmf oracle
   (rtol 1e-4) and, on a small problem, to the f64 loop oracle (rtol 5e-5,
   atol 0.5). Timed against the plain version at B = 65 (true and
   exploded candidates), B = 1 and K = 6,000.
4. Dense main path: 2 EM cycles of the flagship problem from its exploded
   start, nuisance sampling on, every score through the kernel. Checks the
   launch count (and one C1 launch a step), the invariants, that the
   carried likelihood equals the kernel's rescoring bit for bit, that the likelihood rose, and that a
   second run with the same seed is identical.
4a. Repeat kernel B3 (ll_repeat) vs plain on the flagship repeat problem
   (entry.repeat_problem: 12 bins duplicated, K = 1,188 copy rows on
   S = 1,152 data subs): a step's 130 candidates built on the true genome,
   on a genome with one copy deactivated, on the exploded start and on a
   circularised contig holding a repeat copy, rtol 1e-4; at B = 1 (the
   nuisance shape, also held to the dense oracle); every candidate
   bit-identical alone and in its batch; the same on a table where one bin
   is duplicated twice (3 copy rows a data sub); on a copy-dense table
   (about 1,000 copy rows in a block of 64 data subs, so an item's copy
   records cap the candidate chunk below 13): 13 candidates and B = 1; the
   f64 loop oracle on a small repeat problem; and B = 13 on the largest
   dense repeat table (S = 6,000). Timed against the plain version at
   B = 130, 1 and 13.
4b. Dense repeat main path: 2 EM cycles of the repeat problem from its
   exploded start, nuisance sampling on, as in phase 4 (launches
   1 + 2 x steps, carried == rescored, invariants, a second run identical).
5. Delta kernels B4 (obsgrid) and B2 (ll_mini) vs plain, on the real step
   inputs of the chr1-class problem (100,000 fragments, full coverage,
   shuffled into 400 pieces) at f_max 1,024 for the 5 neighbour slots of a
   few fragments: B4 bit-identical on the CSR map and the step's keys
   (activity folded in), and equal to the step's observed grid; B2's scores
   within rtol 1e-4 and its deltas within DLL_ATOL; every genome's B2 score
   bit-identical alone and in its batch; B4 bit-identical on keys that
   crowd a few buckets of its table. Timed against the plain versions at
   R = 1,024 (B4 also as the whole production of the step's masked grid:
   keys and kernel), and both, each held to its plain version and timed
   beside it, at every tier of the ladder, R = 256 to 16,384: up to 4,096
   on the shuffled start, at 8,192 and 16,384 (no contig of the shuffled
   start fills them) on the truth cut so that a piece fills each tier,
   with the peak memory there. Every B2 check prints the shares of its
   (half tile, candidate) classes (empty, band-free, band;
   ``tile_classes_plain``) and fails unless the kernel's own count of each
   class equals the plain classifier's; every tier prints B4's launch plan
   (8 warps a block, the columns of a warp's row buffer). At R = 16,384
   B2 is also held to its plain version on the batch with f_a's contig
   circularised (deltas to max(DLL_ATOL, one f32 ulp): they reach ~5e5).
5c. The delta step's two scoring routes on the same inputs:
   DeltaScorer.score with band_w None (B4 + B2) and with the runner's
   band 996 (B4 + the banded expected mass in plain torch), one step of
   the fragment whose contig fills half the tier, at R = 2,048, 4,096,
   8,192 and 16,384 (5 slots) and for 4 chains at 8,192 (M = 20): wall and
   device ms and peak memory of each; the two routes' deltas within the
   reference's banded-vs-grid tolerance (rtol 1e-3, atol 0.05:
   tests/test_delta.py); and core.delta.effective_band_w on the card
   must route each of those tiers to the route with the lesser wall time.
6. Per-step exactness at 20,000 fragments: 10 single delta steps at f_max
   1,024; after each, the carried likelihood must be within
   max(0.5, 1e-6 |L|) of a full sparse re-anchor.
6a. The same on the repeat twin (entry.scale_repeat_problem with 12
   duplicated bins, the repeat engine v2 and the copy-summing anchor),
   stepping at repeat copies, originals of duplicated bins and contig
   extremities; fails unless a committed step at a repeat fragment moves
   the likelihood by more than the tolerance.
7. Delta main path at 100,000 fragments: ScaleRunner.cycle_for(1024, 4)
   for 256 steps from the shuffled start under
   torch.cuda.set_sync_debug_mode("error"). The carried likelihood must
   stay within 4e-6 |L| of a re-anchor, each step must launch B2, B4 and
   C1 once, and a second seeded run must be identical.
7a. Delta kernels B4 and B2 vs plain on the repeat delta path's own inputs
   (20,000 data bins, 200 of them duplicated: benchmarks/
   bench_scale_repeats.py's problem): the single-copy part of the repeat
   engine v2, whose CSR rows are keyed by data bin (two copies of a bin
   share a key), member rows extracted per neighbour, 10 neighbour slots;
   at a repeat copy, an original of a duplicated bin and a contig
   extremity, with the checks and times of phase 5 at R = 1,024.
7b. Repeat delta main path on that problem: cycle_for(1024, 4) for 256
   steps as in phase 7, with the drift bound max(2, 1e-5 |L|), and one F1
   and one F2 launch a step.
7g. Graph against eager: each main path's cycle built twice, captured
   (the default on the card) and with capture=False (the same step body
   run eagerly), run on the same inputs: the dense flagship (B1), 2 EM
   cycles from the exploded start with nuisance sampling, the second at
   f_t 0.8 on the first's parameters with fact x 1.02 (the catalogue wrapper,
   C1 / C2, among every sampler path's kernels here and in 7h, one C1 call a
   step, two C2 calls a step of MTM / MH); the 100k delta
   path (cycle_for(1024, 4) as the runner builds it) for MAIN_STEPS then
   128 steps (one graph for both lengths), the second chunk at f_t 0.8
   with fact x 1.02; the same for 4 tempered chains (M = 20, per-chain
   parameters and temperatures); the 20k repeat delta path. States,
   likelihoods, parameters and every per-step metric bit for bit, equal
   launches of every wrapper (counts set to 0 before each run, none
   zero); prints each run's wall ms a step (CUDA events around each call;
   the graph's first call holds its eager first step and capture) and peak memory
   (allocated; reserved, the graphs' pool included).
7h. The same for the other sampler cycles, each SAMPLER_STEPS then half as
   many steps (one graph for both, the second call at a lower f_t and, for
   MTM / MH, with fact x 1.02): the tempered dense cycle (4 chains of the
   flagship, one B1 launch at B = 260 a step), the dense MTM and MH cycles
   (the flagship with ``entry.problem_jump_table``, B1 at B = 91 twice a
   step), the delta MTM cycle (the 100k problem at f_max 1,024) and the
   delta MH cycle (the 20k repeat twin, the repeat engine v2; B4 and B2
   twice a step, M = 7); and ScaleRunner.run's cycle end (the sparse
   re-anchor and the nuisance step) for 4 cycles. Each run's first call
   under sync debug mode "error"; launches also equal by key and as the
   path implies. Then ScaleRunner.run_mtm (1 cycle of SAMPLER_STEPS steps
   from the shuffled start): B2 and B4 twice a step, and no scan holding a
   graph, nor 0.5 GB more allocated, once it returns.
8. ScaleRunner.run at 100,000 fragments: 1 cycle of 512 extremity-first
   steps from f_max 256 up the tier ladder, nuisance sampling on; the
   invariants hold and the likelihood rises.
8b. ScaleRunner.run at the top tiers: 1 cycle of 256 extremity-first steps
   from the truth cut into 40 pieces of 2,500 fragments (every step at
   tier 8,192) and from the truth itself (5,000, tier 16,384), twice each:
   one B2 and one B4 launch a step (every chunk's steps counted), no call
   of the banded expected mass (counted), the carried likelihood within
   4e-6 |L| of the cycle's re-anchor, the invariants, the second run
   identical; wall s/cycle and peak memory.
8a. ScaleRunner.run with id_d on the 200-dup problem: 1 cycle of 256
   extremity-first steps, the same checks, and one F1 and one F2 launch a
   step of every cycle chunk (retries included).
9. The CLI on a dataset directory, in this process through
   ``graal_tpu_torch.cli`` (a temporary directory, removed at the end):
   ``simulate`` 3,456 level-0 fragments on 16 contigs, ``pyramid --size 3``
   (the low-coverage filter keeps ~2,900: level 1 ~972 fragments, level 2
   ~329 bins of up to 3, near the flagship width); the pyramid build must
   load the native contact parser.
9a. ``run`` at level 2, 2 EM cycles, nuisance sampling on: B1 launches
   1 + 2 x steps, the invariants, a rising likelihood, the carried
   likelihood equal to B1's rescoring bit for bit, every output file (9
   series, the mutation log, params.json, genome.fasta, info_frags.txt,
   assembly_stats.json, checkpoint.npz); wall s/cycle. Then the run's own
   scorer (B1 on its table and observed map) against its plain version,
   rtol 1e-4, on one step's candidates of the final genome and of the
   exploded start and on each genome alone (also held to the dense
   likelihood), each candidate bit-identical alone and in its batch.
9b. ``run --cycles 1`` then ``run --cycles 2 --resume``: the checkpoint
   equals 9a's bit for bit (state, params, generator state, l_t, metrics).
9c. ``replay`` of 9a's mutation log: the state equals 9a's final state,
   genome.fasta byte for byte.
9d. ``run --scoring delta``, 1 cycle, no nuisance: B2 and B4 launch once
   a step, B1 twice (anchors); the carried likelihood within 4e-6 |L| of
   the cycle's re-anchor; the invariants and outputs. Then the run's own
   B2 and B4 wrappers against their plain versions (B4 bit-identical, B2
   within rtol 1e-4 and DLL_ATOL) at every bucket the run used (f_max 64,
   R = 192 sub rows), on one step's inputs of the exploded start and of
   the final genome, and B1 on the final genome (B = 1).
9e. ``scale`` at level 1 (~972 bins over ~2,900 data subs), 1 cycle of
   512 extremity-first steps from f_max 64: B2 and B4 launch, a finite
   final likelihood, the invariants and outputs; then the runner's B2 and
   B4 against their plain versions as in 9d, at every tier the run used.
9f. ``run --allow-repeats --sampler em,mtm`` on a copy of the dataset with
   fragment 1,500's contacts amplified tenfold: the repeat table goes to
   B3, 1 + 2 x steps launches a stage (each MTM pass one launch at B = 91),
   each stage's carried likelihood equal to B3's rescoring bit for bit, the
   invariants and outputs; then B3 against its plain version as in 9a and
   on an MTM pass's candidates, with the first repeat copy as fA. Then
   ``scale --allow-repeats`` on the same dataset at level 2, 1 cycle of
   256 extremity-first steps: the repeat delta engine (its table's c_max
   printed), one F1 and one F2 launch a step (every cycle chunk's steps
   counted), a finite likelihood, the invariants and outputs.
10a. ``run --sampler em,mtm,mh`` at level 2, 1 cycle a stage: B1 launches
   1 + 2 x steps a stage (EM at B = 65 and 1, every MTM / MH pass one
   launch at B = 91 = 7 neighbour slots x 13), after each stage the carried
   likelihood equal to B1's rescoring bit for bit, the invariants and
   outputs; s/cycle and accept rate per stage; B1 against its plain version
   on an MTM pass's candidates, timed at B = 91.
10b. ``run --sampler tempered --chains 4``, 1 cycle: one B1 launch a step
   at B = 260 for all chains (1 + steps), the cold genome's carried
   likelihood equal to B1's rescoring, every chain's genome valid, the swap
   count; B1 against its plain version on the 4 chains' candidates, timed
   at B = 260.
10c. ``run --level 2 --to-level 1``, 1 cycle a level: B1 at K = 972 and
   then K = 2,901 (1 + 2 x steps each), the projected warm start valid and
   above the exploded level-1 genome, carried == rescored at each level,
   genome.fasta; B1 against its plain version at K = 2,901 at B = 65 and 1
   (and the dense oracle), timed at B = 65.
10d. ``run --model hic``, 1 cycle: no B1 or B3 launch, nuisance sampling
   off, a rising likelihood, the invariants and outputs; one 65-candidate
   batch scored by the HiC scorer on the card and on the CPU, rtol 1e-5.
10e. ``scale --level 2 --steps-per-cycle 256 --mtm-cycles 1``: B2 and B4
   launch twice a delta MTM step (329 steps, MH catalogue, M = 7
   neighbour slots), a finite final likelihood, the invariants and
   outputs; the runner's B2 / B4 against their plain versions on an MTM
   pass (B2 timed at that shape) and at every tier of the run.
10f. On the 20k exactness twin and its 12-dup repeat twin (phase 6's
   set-ups): 10 single delta MTM and 10 delta MH steps each at f_max 1,024,
   B2 and B4 twice a step; after each step the carried likelihood within
   max(0.5, 1e-6 |L|) of a full sparse re-anchor (``bad_steps: 0``) and
   the committed genome valid.
10g. ``scale --level 2 --to-level 1``, 1 cycle a level: B2 and B4 launch
   at both levels, each level's final likelihood finite, the invariants,
   genome.fasta; the last runner's B2 / B4 against their plain versions at
   every tier it used.
11a. Tempered chains at 100,000 fragments (``ScaleRunner.run_chains``, this
   slice's main path): 4 chains from distinct shuffles, each with its own
   parameters. B4 bit-identical and B2 within 0.0039 (scores and deltas)
   of their plain versions on one chains step's inputs, M = 20 slots, B2's
   parameters one row per slot; a (10,) vector and its (20, 10) broadcast
   give the same bits, and so does each chain's slots alone with its own
   vector; both timed at R = 1,024 and at the run's bucket. 4 chains steps
   at f_max 1,024, each chain bit-identical to its single-chain step on the
   same draws, one B2 and one B4 launch a step. A 64-step chunk of all
   chains under sync debug mode "error", every chain within max(0.5, 1e-6
   |L|) of its re-anchor. Then ``run_chains`` itself, counts set to 0 just
   before: 1 cycle of 256 steps from f_max_min 1,024 (the bucket follows
   the largest contig of any chain: 4,096 on the shuffled start, below
   the top tiers), nuisance sampling and one swap round; launches
   exactly one B2 and one B4 a step, every chain's carried likelihood
   within max(0.5, 1e-6 |L|) of its re-anchor, the invariants, the best
   likelihood above the start's.
11b. The same on the 20k repeat twin, 3 chains (M = 30): the chains steps
   held to single-chain steps, 10 chains steps each re-anchored
   (``bad_steps: 0``), and ``run_chains`` for 128 steps with the drift
   bound max(2, 1e-5 |L|), one F1 and one F2 launch a step for all
   chains.
11c. ``scale --chains 4 --t-max 4`` at level 1, 2 cycles of 128 steps a
   chain: one B2 and one B4 launch a step, the outputs; ``--cycles 1``
   then ``--cycles 2 --resume`` equals the uninterrupted run (final genome,
   genome.fasta, every checkpoint entry but the wall times); then, at 64
   steps a cycle, with ``--snapshot-every 1 --watch --profile`` (the
   traced cycle is one chain's): live.html, live_status.json,
   live_particles.json and a profiler trace that names ``ll_mini_items``
   and ``obsgrid_rows`` (paintings only where matplotlib is installed).
   And ``run --snapshots --watch --profile --snapshot-every 1`` at level
   2 of a 576-fragment dataset (a traced cycle costs several untraced
   ones): the .npy snapshots, the live files, a trace that names
   ``ll_dense_items``.
11d. ``parallel.sharding`` on the card: a 1-rank NCCL world in this process
   (FileStore): the sharded dense likelihood, the sharded sparse anchor (4
   chains, their own params, the 20k problem) and a sharded delta cycle (4
   chains, 32 steps) bit for bit the one-process results; a 2-rank gloo
   world, both ranks on cuda:0 (two processes of this script, each with a
   timeout): likelihood and anchor within rtol 1e-5 / 1e-6, the chains
   split over the ranks bit for bit the one-process chains; with several
   cards, NCCL across them too. The results go on a JSON line before the
   nvidia-smi line.
11e. run_chains at the top buckets: 4 chains from the truth cut into 40
   pieces (bucket 8,192, M = 20) for 64 steps and from the truth (bucket
   16,384, M = 20) for 8, with 11a's checks of run_chains (no rise asked
   of the likelihood: the starts are all but assembled) and no call of the
   banded mass, peak memory; then B4 and B2 against their plain versions
   and timed on a chains step's inputs at each bucket (the scores held to
   RTOL there: B2_ABS_ERR is a few ulps of the lower buckets' scores).
11g. (``--top-tiers`` only) 7g's check on 11e's 4 chains from the truth
   at bucket 16,384 (M = 20), 8 then 4 steps, with each run's peak memory:
   the graph must fit where the eager run does.
11h. (``--top-tiers`` only) 7h's run_mtm check from the truth (bucket
   16,384, two passes of M = 7 a step), 8 steps, with its peak memory.
12. Last lines: the nvidia-smi line, one JSON line on the kernels run, and
   {"ok": true, "device": {...}}. Each kernel's entry has the contract's
   keys (launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
   library_ms: null where no single PyTorch call computes the kernel's
   function; G2's is torch.topk's on the plain version's key)
   and device_ms and share, at its flagship shape (B1: B = 65, K = 1,152,
   true candidates; B3: S = 1,152; B2 / B4: the 100k path at R = 1,024;
   B4 also grid_ms / grid_device_ms, the step's whole observed-grid
   production); the other shapes sit under "by_shape" (B1: exploded,
   B = 1, K = 6,000, and the new paths' B = 91, B = 260 and K = 2,901; B3;
   B2's MTM shape), "tiers" (B2, B4) and "by_path" (each path's launches:
   the main paths of phases 4-8 and the CLI runs cli_run, cli_run_delta,
   cli_scale, cli_run_repeats, cli_run_mtm, cli_run_tempered,
   cli_run_multilevel, cli_run_hic (0 launches), cli_scale_mtm,
   cli_scale_multilevel, cli_scale_chains, each CLI run's entry with the
   max abs error of its kernel against the plain version there,
   delta_mtm_exactness with its bad steps, run_chains_100k, whose launches
   join the top-level count, and run_chains_repeat_20k, and the top
   tiers' main paths run_top_8192, run_top_16384 (8b), run_chains_top_8192
   and run_chains_top_16384 (11e), whose launches join it too); B2's and
   B4's chains shapes (M = 20 at R = 1,024, at the run's bucket, at 8,192
   and at 16,384) under "by_shape". C1 (em_catalogue) and C2 (mh_catalogue)
   mirror graal_tpu/core/candidates.py:48 and :86 (no Pallas kernel: XLA
   fuses them in the jitted step) at the EM step's B = 5 and an MTM pass's
   B = 7, with phase 3c's other shapes under "by_shape" and each main
   path's launches under "by_path" (phases 4, 4b, 7, 7b, every graphed
   cycle of 7g / 7h), summed into the top-level count. step_head (D2's
   draw with D1's proposal), step_tail (D1's Metropolis test with the l_t
   select and the metrics) and select_commit (D3) mirror
   graal_tpu/core/mcmc.py:144 (with :297), :368 (with :444-468) and :178
   (no Pallas kernel: XLA fuses them in the jitted step) at the dense
   flagship's shape (the head with both parts, the tail with all three, D3
   the dense entry), with phase 3d's other shapes under "by_shape" and each
   main path's launches under "by_path" (phases 4, 4b, 7, 7b and the
   graphed cycles of 7g / 7h). E1 (mtm_set), E2 (mtm_draw) and E3
   (mtm_accept) mirror graal_tpu/core/mtm.py:124, :181 and :198 (no Pallas
   kernel: XLA fuses them in the jitted step) at the dense flagship MTM
   shape, with phase 3e's other shapes under "by_shape" and each main
   path's launches under "by_path" (7h's graphed cycles and run_mtm, 10a,
   10e). F1 (repeat_corr_frozen) and F2 (repeat_corr_sums) mirror
   graal_tpu/core/delta_repeats.py:590 and :748 (no Pallas kernel: XLA
   fuses them in the jitted step) at the 20k repeat delta EM step's shape
   (M = 10, R = 1,024), with phase 3f's other shapes under "by_shape" and
   each repeat path's launches under "by_path" (7b, the graphed 20k
   repeat delta and delta MH cycles of 7g / 7h, 8a, 11b's run_chains,
   9f's scale), summed into the top-level count. G1 (rows_counts), G2
   (rows_write) and G3 (rows_gather) mirror graal_tpu/core/delta.py:100,
   :121 and :179 (no Pallas kernel: XLA fuses them, its top_k lowered to a
   sort, in the jitted step) at the 100k delta EM step's shape (union,
   M = 5, f_max 1,024), with phase 3g's other shapes under "by_shape" and
   each delta path's launches under "by_path", summed into the top-level
   count. H1 (vectors) mirrors graal_tpu/ops/likelihood_pallas.py:259
   (``sub_vectors``, with ``params_vector`` :215 and ``copy_vectors`` :666,
   fused by XLA into the pallas_call's operands) at the dense flagship EM
   step's B = 65, H2 (scan_load: a call's first load) and H3 (scan_store:
   a step's stores and the next step's loads) graal_tpu/core/mcmc.py:468
   (``lax.scan``, which slices, stacks and aliases inside one XLA program)
   at the dense flagship EM cycle's step, with phase 3h's
   other shapes and trees under "by_shape" and each main path's launches
   under "by_path" (phases 4, 4b, 7, 7b and the graphed cycles of 7g /
   7h), summed into the top-level count; H3's library_ms is
   torch._foreach_copy_'s on the same carry leaves, and it carries the
   separate store-only and load-only launches' times as separate_ms /
   separate_device_ms. Before them, a JSON line
   of phase 5c's routes. (``--top-tiers``
   adds D3's delta entry on 4 chains at 16,384, M = 20, and E1-E3 at the
   16,384 bucket to its line.)
"""

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

RTOL = 1e-4                 # kernel vs plain / dense oracle (bench.py:59)
REF_RTOL, REF_ATOL = 5e-5, 0.5   # vs the f64 loop oracle (tests/test_parity.py)
N_CYCLES = 2
SEED = 0
LARGE_BINS = 2000           # K = 6,000: the largest table scored densely
SCALE_BINS = 100_000        # the chr1-class problem (bench_scale.py)
EXACT_BINS = 20_000         # benchmarks/check_exactness.py's size
F_MAX = 1024                # the flagship delta bucket
TOP_F_MAX = 4096            # the top tier of the shuffled 100k start
# the tiers of assembled contigs: 2,500 fragments (half a true contig) put
# a step at 8,192, a whole true contig of 5,000 at 16,384 (scale.py's cap)
TOP_TIERS = (8192, 16384)
TIERS = (256, 512, 1024, 2048, TOP_F_MAX) + TOP_TIERS   # ScaleRunner.run's ladder
CROSS_TIERS = (2048, 4096, 8192, 16384)   # the delta routes timed against each other (5c)
# grid route vs banded route, dll: the reference's own banded-vs-grid
# tolerance (tests/test_delta.py:99)
BAND_RTOL, BAND_ATOL = 1e-3, 0.05
PLAIN_GRID_BYTES = 3 << 30  # B4's plain version: at most this much grid at once
RUNNER_TOP_STEPS = 256      # ScaleRunner.run steps at each top tier (8b)
TOP_CHAIN_STEPS = 64        # run_chains steps at bucket 8,192 (11e)
TOP16_CHAIN_STEPS = 8       # and at 16,384
DELTA = 4
MAIN_STEPS = 256            # bench_scale.py's timed chunk
# B2 deltas, kernel vs plain: both sum f32 cells in f64, so they differ by
# the cells' last-ulp differences only; 0.05 is 10x below the 0.5 floor of
# the per-step exactness gate (phase 6) that a delta error would break.
DLL_ATOL = 0.05
DRIFT_REL = 4e-6            # carried vs re-anchored, 256 steps (bench.py:231)
REPEAT_CYCLES = 2
REPEAT_DUPS = 200           # benchmarks/bench_scale_repeats.py
EXACT_REPEAT_DUPS = 12      # benchmarks/check_exactness_repeats.py
DATASET_BINS = 3456         # level 0 of the CLI phases (level 1 ~972, level 2 ~329 bins)
DATASET_CONTIGS = 16        # the flagship's contigs (__graft_entry__._problem)
CLI_CYCLES = 2
AMPLIFIED_FRAG = 1500       # 1-based level-0 fragment made a repeat in phase 9f
CHAINS = 4                  # tempered chains of phase 10b (the CLI's default)
MTM_DELTA = 5               # the MTM / MH stages' jump-table partners (Runner.run_mtm)
MTM_SLOTS = 13 * (MTM_DELTA + 2)   # candidates of one MTM / MH pass (B = 91)
MTM_EXACT_STEPS = 10
SAMPLER_STEPS = 64          # steps of each sampler cycle of phase 7h's first call
# the CLI stages' wall s/cycle (phases 10a, 10b) on one NVIDIA H100 80GB HBM3 at
# 700 W before the MTM, MH and tempered cycles were captured (EM already was;
# PERF.md section 5), printed beside this run's
EAGER_CYCLES_S = {"em": 0.979, "mtm": 11.354, "mh": 9.515, "tempered": 4.417}
CHAIN_EQ_STEPS = 4          # chains steps held to single-chain steps (11a, 11b)
CHAIN_CHUNK = 64            # the chains' chunk run under sync debug "error" (11a)
CHAIN_STEPS = 256           # run_chains' main path: 1 cycle of 256 steps a chain (11a)
B2_ABS_ERR = 0.0039         # B2 vs plain at per-chain params (the CLI paths' largest B2 error)
CAT_PAIRS = 2000            # random (f_a, f_b) pairs each catalogue shape is held to plain on
CAT_CHUNK_CELLS = 1 << 22   # genomes x fragments of one compared call (phase 3c)
CAT_TIME_ITERS = 50
# C1 / C2 launches of the main paths, by path: {"em": n, "mh": n} each
CATALOGUE_PATHS = {}
CAT_EDGE_N = (1, 257, 2049)  # 3c / 3d's edge genomes: one fragment; one past 1 and 8 blocks of 256
CAT_EDGE_ROWS = 7           # 3c: one row a genome of the 257-fragment one, the whole state's maximum
CAT_CALLS = {}              # calls made to C1 / C2 by kind since a phase reset their counters
STEP_CALLS = {}             # calls made to the step kernels by kind since a phase reset them
STEP_DRAWS = 2000           # random draws a shape each step kernel is held to its plain version on
STEP_CHUNK = 250            # draws of one compared dense selection (phase 3d)
STEP_DELTA_CHUNK = 64       # draws of one compared delta commit, each into its own genome copy
STEP_TIME_ITERS = 200
SLOT_ULPS = 4               # the drawn slot's margin: its best two keys within 4 ulps of the best
STEP_PATHS = {}             # each main path's step kernel launches by key (the kernels line)
MOVE_DRAWS = 2000           # random draws a shape each MTM / MH kernel is held to its plain one on
MOVE_PIVOTS = 250           # pivots of those draws (one forward pass scored a pivot)
MOVE_TIME_ITERS = 200
MOVE_ULPS = 4               # the draw's and the acceptance's margin
MOVE_PATHS = {}             # each main path's E1-E3 launches by key (the kernels line)
MOVE_SHAPES = {}            # phase 3e's shapes, 10a's level-1 one and --top-tiers' 16,384 one
MANY_COPIES = 12            # 3f: most copies of a bin in the many-copy shape (2 to 12)
CORR_DRAWS = 2000           # random (f_a, neighbour) slots a shape F1 / F2 are held to plain on
# F1 / F2 vs plain: corr and cross are f64 sums of the same f32 terms in
# another order (rtol), dll their f32 rounding (DLL_ATOL or one ulp)
CORR_RTOL, CORR_ATOL = 1e-12, 1e-9
CORR_TIME_ITERS = 200
N_GEN_ROWS = 14             # genomes a neighbour slot (base + 13 candidates)
CORR_PATHS = {}             # each repeat path's F1 / F2 launches by key (the kernels line)
CORR_SHAPES = {}            # phase 3f's shapes and --top-tiers' R = 8,192 one
ROWS_DRAWS = 2000           # random (chain, slot) draws a shape G1-G3 are held to plain on
ROWS_TIME_ITERS = 200
EDGE_N = 2000               # 3g's f_max = n shapes: a cut of the 20k repeat genome
ROW_COPIES = 16             # 3g: most copies of a bin in the m >= 65 shape (2 to 16: m = 80)
SLOT_COPIES = 64            # 3g: most copies of a bin in the m in the hundreds shape (m = 320)
ROWS_PATHS = {}             # each delta path's G1-G3 launches by key (the kernels line)
ROWS_SHAPES = {}            # phase 3g's shapes and --top-tiers' f_max 16,384 one
INPUTS_DRAWS = 1000         # random (chain, slot) draws a shape I1 / I2 are held to plain on
INPUTS_TOP_DRAWS = 200      # the same at f_max 16,384 (--top-tiers)
INPUTS_TIME_ITERS = 200
INPUTS_SHAPES = {}          # phase 3i's shapes, 9d's CLI one and --top-tiers' f_max 16,384 one
SETUPS = {}                 # set-ups a later phase shares (3g's many-copy problem)
VEC_TIME_ITERS = 200
SCAN_TIME_ITERS = 200
VEC_SHAPES = {}             # phase 3h's H1 shapes
SCAN_TREES = {}             # phase 3h's H2 / H3 trees, one a sampler's Scan
IO_PATHS = {}               # each main path's H1-H3 launches by key (the kernels line)
CLI_CHAIN_STEPS = 128       # scale --chains steps a chain a cycle (11c)
SMALL_BINS = 576            # 11c's run --profile dataset (level 2 ~60 bins)
CLI_WATCH_STEPS = 64        # the same with --watch --profile: a traced cycle is slow
DIST_STEPS = 32             # the sharded delta cycle's steps (11d)
DIST_TIMEOUT_S = 300        # each process of an 11d world


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def run_cmd(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    check(r.returncode == 0, f"{cmd[0]} failed: {r.stderr.strip()}")
    return r.stdout.strip()


def gpu_line():
    return run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]


def cuda_ms(fn, n_iter, n_warm=2):
    """Mean time of fn() in ms between CUDA events around n_iter calls. At
    a few microseconds a call this times the host's enqueue, not the
    kernel: :func:`device_ms` reads the kernels' own time."""
    import torch

    for _ in range(n_warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_iter):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n_iter


def device_ms(fn, n_iter, n_warm=2):
    """ms per call of fn() on the device alone: CUDA events around n_iter
    calls queued behind a spin kernel (torch.cuda._sleep) that outlasts
    their enqueue on the host, so the calls run back to back and no host
    time is counted."""
    import torch

    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int((2.0 * host_s + 1e-3) * max_sm_clock_hz()))
    start.record()
    for _ in range(n_iter):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n_iter


def timed(fn, n_iter, plain=None, n_plain=3):
    """ms per call of fn(): event-timed as called (host enqueue included)
    and on the device alone; and the plain version's event-timed ms."""
    out = dict(ms=cuda_ms(fn, n_iter), device_ms=device_ms(fn, n_iter))
    if plain is not None:
        out["plain_ms"] = cuda_ms(plain, n_plain, n_warm=1)
    return out


@functools.cache
def max_sm_clock_hz():
    return float(run_cmd(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"]).splitlines()[0]) * 1e6


# Peak rates of one H100 SXM (NVIDIA's published figures): HBM
# bytes/s and FP32 FLOP/s outside the tensor cores; the special-function
# units issue 16 operations per clock on each of the 132 SMs.
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
SFU_PER_SM_CLOCK = 16
N_SM = 132


def bound(n_bytes, fp32_ops=0.0, sfu_ops=0.0):
    """The least time (ms) the card could take for this work, and what sets
    it: max(bytes / HBM rate, FP32 operations / FP32 rate, special-function
    operations / (132 x 16 x the SM's maximum clock)). ``bound_by`` is
    "bytes" or "operations", ``bound_term`` which of the three."""
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S, "fp32": fp32_ops / FP32_PER_S,
             "sfu": sfu_ops / (N_SM * SFU_PER_SM_CLOCK * max_sm_clock_hz())}
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term] * 1e3, bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, n_bytes=int(n_bytes), fp32_ops=int(fp32_ops),
                sfu_ops=int(sfu_ops))


def with_share(t, b):
    """Timing ``t`` and bound ``b`` in one record, with the share of the
    bound in the device time."""
    return dict(t, **b, share=b["bound_ms"] / t["device_ms"])


def in_range_masks(mid, idc, d_max, pairs, active=None):
    """For each genome of (G, N) vectors in turn, the (N, N) bool mask of
    its same-contig pairs with 0 < |mid_u - mid_v| < d_max among ``pairs``;
    ``active`` (G, N) keeps only pairs of two active rows."""
    for g in range(mid.shape[0]):
        s = (mid[g, :, None] - mid[g, None, :]).abs()
        ok = pairs & (idc[g, :, None] == idc[g, None, :]) & (s > 0) & (s < d_max)
        if active is not None:
            ok &= active[g, :, None] & active[g, None, :]
        yield ok


def in_range_pairs(mid, idc, d_max, pairs, active=None):
    """The pairs of :func:`in_range_masks`, summed over the genomes."""
    return sum(int(ok.sum()) for ok in in_range_masks(mid, idc, d_max, pairs, active))


def scorer_counts(n_cells, n_cis, extra_sfu=0):
    """FP32 and special-function operations of a scorer call: 6 per cell a
    candidate evaluates, 10 FP32 and 3 special-function per same-contig
    pair inside (0, d_max), plus ``extra_sfu``."""
    return dict(fp32_ops=6.0 * n_cells + 10.0 * n_cis, sfu_ops=3.0 * n_cis + extra_sfu)


def upper_mask(n, device):
    import torch

    return torch.ones((n, n), dtype=torch.bool, device=device).triu(1)


def upper_cells(n):
    """Cells u < v of an n x n plane: all a scorer reads of it."""
    return n * (n - 1) // 2


def dense_bound(vecs, pvec):
    """Bound of a B1 call on (B, K) vectors, counting what these inputs
    need. A trans cell's term, ob (log_v + la_pair) - v_inter accu_u accu_v
    / nfpb, does not depend on the genome, so its sum over every cell u < v
    is one constant per scorer, and a candidate's score is that constant
    plus, over its same-contig pairs inside (0, d_max), the cis term less
    the trans term: the operations of :func:`scorer_counts` for one cell
    and one such pair each, and no test (finding the pairs is a pass over
    the vectors, whose bytes are counted). Bytes: the four vectors, the
    three (K,) factors and the scores once, and the observed cell of every
    such pair of some candidate once."""
    import torch

    mid, idc = vecs[0], vecs[1]
    b, k = mid.shape
    need = torch.zeros((k, k), dtype=torch.bool, device=mid.device)
    cis = 0
    for ok in in_range_masks(mid, idc, pvec[3].item(), upper_mask(k, mid.device)):
        cis += int(ok.sum())
        need |= ok
    return bound(4 * (int(need.sum()) + 4 * b * k + 3 * k + b), **scorer_counts(cis, cis))


def repeat_bound(scorer, vecs, pvec):
    """Bound of a B3 call on (B, K) copy vectors: obs and lf (their upper
    triangles), the five vectors and the copy ranges read once, the scores
    written once; same-contig
    copy pairs of two active copies on two data subs, and the data cells
    with more than one active copy pair and ob > 0 (one logf of E each)."""
    import torch

    mid, idc, a = vecs[0], vecs[1], vecs[4]
    b, k = mid.shape
    s = scorer.s
    dev = mid.device
    data = torch.repeat_interleave(torch.arange(s, device=dev),
                                   torch.diff(scorer.copy_start.long()))
    active = a > 0
    cis = in_range_pairs(mid, idc, pvec[3].item(), data[:, None] < data[None, :], active)
    n_act = torch.zeros((b, s), device=dev).index_add_(1, data, active.float())
    cells = upper_mask(s, dev) & (scorer.obs > 0)
    multi = sum(int(((n_act[g, :, None] * n_act[g, None, :] > 1) & cells).sum())
                for g in range(b))
    return bound(4 * (2 * upper_cells(s) + 5 * b * k + s + 1 + b),
                 **scorer_counts(b * upper_cells(s), cis, multi))


# FP32 operations of a band-free (half tile, candidate) per row or column:
# its share of the class test (id, min, max) and of the closed form's sums
FREE_OPS_PER_LINE = 6


@functools.cache
def half_tile_cells(r, device):
    """(n_tri, 2) cells u < v < R of each half tile of an R x R grid, tiles
    in B2's partial order."""
    import torch
    from graal_tpu_torch.ops.mini_grid_cuda import tri_tiles

    t = 64
    n_rb = -(-r // t)
    bi, bj = tri_tiles(n_rb, device)
    u = torch.arange(t // 2, device=device)
    v = torch.arange(t, device=device)
    out = []
    for half in range(2):
        rows = (bi * t + half * t // 2)[:, None, None] + u[None, :, None]
        cols = (bj * t)[:, None, None] + v[None, None, :]
        out.append(((cols > rows) & (rows < r) & (cols < r)).sum((1, 2)))
    return torch.stack(out, -1)


def mini_classes(args):
    """B2's class of every (half tile, candidate) of a call, by its rule in
    plain torch (``tile_classes_plain``), and their counts (empty,
    band-free, band)."""
    import torch
    from graal_tpu_torch.ops.mini_grid_cuda import tile_classes_plain

    cls = tile_classes_plain(args[0], args[1], args[4], args[5], args[6])
    return cls, torch.bincount(cls.flatten().long(), minlength=3).tolist()


def mini_bound(args, cls=None):
    """Bound of a B2 call, counting what these inputs need: the cell
    operations of the band (half tile, candidate) pairs only (6 FP32 a cell,
    and 10 FP32 and 3 special-function per same-contig pair of two live
    rows inside (0, d_max), all of which lie in band pairs), 2 x 96 x
    FREE_OPS_PER_LINE / 2 for a band-free pair's rows and columns, nothing
    for an empty one; the bytes of the observed half tiles (their cells u <
    v) some candidate's class needs, the five (M, C, R) vectors (and the
    (M, 10) parameter rows, whose rows give each slot its own d_max) read
    once, scores and deltas written once. ``cls`` is
    :func:`mini_classes`' classes of the call, computed when not given."""
    from graal_tpu_torch.ops.mini_grid_cuda import BAND, DEAD_LA, EMPTY, FREE

    mid, idc, la = args[0], args[1], args[4]
    m, c, r = mid.shape
    pvec = args[6].expand(m, args[6].shape[-1])
    if cls is None:
        cls = mini_classes(args)[0]
    cells = half_tile_cells(r, str(mid.device))
    band_cells = int(((cls == BAND).long() * cells).sum())
    n_free = int((cls == FREE).sum())
    ob_cells = int(((cls != EMPTY).any(1).long() * cells).sum())
    pairs = upper_mask(r, mid.device)
    cis = sum(in_range_pairs(mid[a], idc[a], pvec[a, 3].item(), pairs, la[a] > DEAD_LA)
              for a in range(m))
    counts = scorer_counts(band_cells, cis)
    counts["fp32_ops"] += FREE_OPS_PER_LINE * 96.0 * n_free
    return bound(4 * (ob_cells + 5 * m * c * r + m * c + m * (c - 1) + pvec.numel()), **counts)


def obsgrid_bound(b4):
    """Bound of a B4 call on (row_start, cols, vals, keys): the CSR entries
    of the rows read (a column and a count, 8 bytes each) and their two row
    offsets, the M x R keys, and the M x R x R grid written."""
    import torch

    row_start, _, _, keys = b4
    m, r = keys.shape
    k = keys.long()
    ok = k >= 0
    kc = k.clamp_min(0)
    entries = int(torch.where(ok, row_start[kc + 1] - row_start[kc], 0).sum())
    return bound(8 * entries + 16 * int(ok.sum()) + 4 * m * r + 4 * m * r * r)


class PeakMemory:
    """Peak device memory from here on: :meth:`read` returns
    torch.cuda.max_memory_allocated in GB and the part of it above what
    was held at the start, and prints them under ``label`` if given."""

    def __init__(self):
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.base = torch.cuda.memory_allocated()

    def read(self, label=None):
        import torch

        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if label is not None:
            print(f"  peak memory, {label}: {peak / 1e9} GB allocated ({(peak - self.base) / 1e9}"
                  f" GB above the {self.base / 1e9} GB held before)")
        return peak / 1e9, (peak - self.base) / 1e9


def fmt_bound(t):
    return (f"bound {t['bound_ms']:.6f} ms ({t['bound_term']}: {t['n_bytes']} bytes, "
            f"{t['fp32_ops']} fp32, {t['sfu_ops']} sfu ops), share {t['share']:.4f}")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this check "
                           "runs on a GPU only")
    from graal_tpu_torch.ops.build import find_nvcc

    print(f"gpu: {gpu_line()}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    print(f"nvcc: {run_cmd([find_nvcc(), '--version']).splitlines()[-1]}")
    return torch.device("cuda", 0)


def phase_build():
    from graal_tpu_torch.ops import build

    t0 = time.perf_counter()
    seconds = build.build()
    print(f"build: {len(seconds)} of {len(build.KERNELS)} libraries compiled in "
          f"parallel, {time.perf_counter() - t0:.2f} s wall")
    for name in build.KERNELS:
        so = build.library_path(name)
        check(so.exists(), f"{so} was not built")
        print(f"  {so.name}: {seconds.get(name, 0.0):.2f} s")
        log = so.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"    ptxas: {line.strip()}")


def candidate_batch(state, nb, f_a, gen, n_nb=None):
    """Flat (m*13, n) batch of the candidates of f_a against neighbours
    drawn as the EM step draws them."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.candidates import N_CANDIDATES, build_candidates
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import DELTA

    f_a = torch.tensor(f_a, device=state.pos.device)
    ids, _ = mcmc.sample_neighbours(gen, f_a, state, nb, DELTA)
    if n_nb is not None:
        ids = ids[:n_nb]
    cands = build_candidates(state, f_a, ids)
    m = ids.shape[0]
    return GenomeState(*[x.reshape(m * N_CANDIDATES, -1).contiguous() for x in cands])


def circularised(state, contig=0):
    """The genome with contig ``contig`` circularised (its ends pasted)."""
    import numpy as np
    import torch
    from graal_tpu_torch.core import ops
    from graal_tpu_torch.core.state import GenomeState

    s = state.to_numpy()
    members = np.nonzero(s["id_c"] == contig)[0]
    order = members[np.argsort(s["pos"][members])]
    dev = state.pos.device
    one = GenomeState(*[x[None] for x in state])
    out = ops.paste(one, torch.tensor([order[0]], device=dev),
                    torch.tensor([order[-1]], device=dev), one.id_c.amax(-1))
    out = GenomeState(*[x[0] for x in out])
    check(int(out.circ[order[0]]) == 1, "circularisation failed")
    return out


def stack(states):
    import torch
    from graal_tpu_torch.core.state import GenomeState

    return GenomeState(*[torch.cat(xs).contiguous() for xs in zip(*states)])


def kernel_vs_plain(scorer, batch, params, label):
    """Kernel and plain version on the same vectors; returns (kernel
    scores, max abs error)."""
    import torch
    from graal_tpu_torch.ops.likelihood_cuda import params_vector

    vecs = scorer.sub_vectors(batch)
    pvec = params_vector(params, scorer.log_nfpb)
    got = scorer.launch(*vecs, pvec)
    want = scorer.plain(*vecs, pvec)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite kernel scores")
    err = (got.double() - want.double()).abs()
    rel = (err / want.double().abs()).max().item()
    print(f"  {label}: B={got.shape[0]} K={scorer.k} max_abs_err={err.max().item():.6g} "
          f"max_rel_err={rel:.3g}")
    check(rel <= RTOL, f"{label}: kernel vs plain rel err {rel} > {RTOL}")
    return got, err.max().item()


def batch_invariance(scorer, batch, params, scores, label):
    """Each candidate scored alone must equal its score in the batch."""
    import torch
    from graal_tpu_torch.core.state import GenomeState

    for i in range(batch.pos.shape[0]):
        alone = scorer(GenomeState(*[x[i:i + 1] for x in batch]), params)
        check(torch.equal(alone, scores[i:i + 1]),
              f"{label}: candidate {i} alone {alone.item()!r} != in batch "
              f"{scores[i].item()!r}")
    print(f"  {label}: {batch.pos.shape[0]} candidates bit-identical alone and in batch")


def check_bases(scorer, table, params, nb, bases, gen):
    """The kernel against its plain version on the candidates of one step
    of each base genome (``bases``: (name, genome, f_a, with_oracle)) and
    on the genome alone (B = 1), that one also held to the dense oracle
    ``log_likelihood`` where ``with_oracle``; every candidate bit-identical
    alone and in its batch, and all batches in one. Returns (max abs error,
    the candidate batches)."""
    import torch
    from graal_tpu_torch.core.likelihood import log_likelihood
    from graal_tpu_torch.core.state import GenomeState

    max_err = 0.0
    batches, scores = [], []
    for name, base, f_a, with_oracle in bases:
        batch = candidate_batch(base, nb, f_a, gen)
        got, err = kernel_vs_plain(scorer, batch, params, f"{name} candidates (f_a={f_a})")
        max_err = max(max_err, err)
        batches.append(batch)
        scores.append(got)
        got1, err = kernel_vs_plain(scorer, GenomeState(*[x[None] for x in base]), params,
                                    f"{name} genome (B=1)")
        max_err = max(max_err, err)
        if with_oracle:
            want = log_likelihood(base, table, scorer.obs, params)
            rel = abs(got1.item() - want.item()) / abs(want.item())
            print(f"    vs dense oracle log_likelihood: rel err {rel:.3g}")
            check(rel <= RTOL, f"{name}: kernel vs log_likelihood {rel} > {RTOL}")
    for batch, got, (name, *_) in zip(batches, scores, bases):
        batch_invariance(scorer, batch, params, got, f"{name} candidates")
    got_all = scorer(stack(batches), params)
    check(torch.equal(got_all, torch.cat(scores)),
          f"a {got_all.shape[0]}-candidate batch differs from its {len(batches)} batches")
    print(f"  {got_all.shape[0]} candidates in one batch: bit-identical")
    return max_err, batches


def check_small_oracle(build, device):
    """The kernel against the f64 loop oracle on a small problem."""
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.likelihood import log_likelihood_ref
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    state, table, params, obs, _ = build(device)
    scorer = make_dense_scorer(table, obs, device)
    for name, st in (("true", state), ("exploded", mcmc.explode_genome(state))):
        got = scorer(GenomeState(*[x[None] for x in st]), params)[0].item()
        ref = log_likelihood_ref(st, table, obs, params)
        print(f"  small S={table.n_data_sub} K={table.n_subs} {name}: kernel {got:.6f} "
              f"vs f64 oracle {ref:.6f}")
        check(abs(got - ref) <= REF_ATOL + REF_RTOL * abs(ref),
              f"small {name}: kernel {got} vs f64 oracle {ref}")


def check_large(build, device, f_a, gen):
    """One 13-candidate batch of the largest dense table: the kernel
    against its plain version, batch invariance and both times. Returns
    (the max abs error, the shape: scorer, vectors, pvec, timing)."""
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer, params_vector

    state, table, params, obs, nb = build(device)
    scorer = make_dense_scorer(table, obs, device)
    batch = candidate_batch(state, nb, f_a, gen, n_nb=1)
    got, err = kernel_vs_plain(scorer, batch, params, "large candidates")
    batch_invariance(scorer, batch, params, got, "large candidates")
    vecs = scorer.sub_vectors(batch)
    pvec = params_vector(params, scorer.log_nfpb)
    t = timed(lambda: scorer.launch(*vecs, pvec), 20,
              lambda: scorer.plain(*vecs, pvec), n_plain=2)
    print(f"  time B=13 S={table.n_data_sub} K={scorer.k}: {fmt_time(t)}")
    return err, dict(scorer=scorer, vecs=vecs, pvec=pvec, timing=t)


def fmt_time(t):
    out = f"kernel {t['ms']:.4f} ms (as called), {t['device_ms']:.4f} ms (device)"
    return out + (f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t else "")


def phase_kernel(device, n_bins=384, large_bins=LARGE_BINS):
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.entry import problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer, params_vector

    print("kernel vs plain:")
    state, table, params, obs, nb = problem(n_bins=n_bins, device=device)
    scorer = make_dense_scorer(table, obs, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = state.n_frags
    bases = [("true", state, 7, True), ("exploded", mcmc.explode_genome(state), 107 % n, True),
             ("circular", circularised(state), 207 % n, False)]
    max_err, batches = check_bases(scorer, table, params, nb, bases, gen)

    # timing at the main path's shapes: 65 candidates of the true genome
    # (most half tiles far from the diagonal pure-trans) and of the
    # exploded start (nearly all of them), and the nuisance call's B = 1
    pvec = params_vector(params, scorer.log_nfpb)
    timing = {}
    vecs = {name: scorer.sub_vectors(b) for name, b in (("true", batches[0]),
                                                        ("exploded", batches[1]))}
    vecs["B=1"] = [x[:1].contiguous() for x in vecs["true"]]
    for name, v in vecs.items():
        t = timed(lambda: scorer.launch(*v, pvec), 50, lambda: scorer.plain(*v, pvec), 5)
        timing[name] = with_share(t, dense_bound(v, pvec))
        print(f"  time B={v[0].shape[0]} K={scorer.k} ({name}): {fmt_time(t)}; "
              f"{fmt_bound(timing[name])}")

    check_small_oracle(lambda dev: problem(n_bins=24, n_contigs=3, device=dev), device)
    err, large = check_large(lambda dev: problem(n_bins=large_bins, device=dev), device, 11,
                             gen)
    timing["K6000"] = with_share(large["timing"], dense_bound(large["vecs"], large["pvec"]))
    print(f"  B=13 K={large['scorer'].k}: {fmt_bound(timing['K6000'])}")
    return dict(max_abs_err=max_err, max_abs_err_k6000=err, **timing["true"],
                by_shape={"B1_B65_exploded": timing["exploded"], "B1_B1": timing["B=1"],
                          "B1_K6000": timing["K6000"]})


def main_path_run(device, build, n_cycles):
    """One seeded run: explode the problem ``build(device)`` returns, then
    ``n_cycles`` EM cycles through its dense scorer's kernel. Returns the
    final state, params, l_t and what was measured."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import DELTA
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    state, table, params, obs, nb = build(device)
    scorer = make_dense_scorer(table, obs, device)
    cycle = mcmc.make_em_cycle(table, obs, nb, DELTA, sample_param=True,
                               scorer=scorer)
    n = state.n_frags
    gen = torch.Generator(device=device).manual_seed(SEED)
    cur = mcmc.explode_genome(state)
    torch.cuda.synchronize()
    scorer.n_launches = catalogue_wrapper().n_launches = step_wrapper().n_launches = 0
    rows_wrapper().n_launches = inputs_wrapper().n_launches = 0
    vectors_wrapper().n_launches = scan_wrapper().n_launches = 0
    l0 = scorer(GenomeState(*[x[None] for x in cur]), params)[0]
    l_t, par = l0, params
    seconds = []
    for c in range(n_cycles):
        order = torch.randperm(n, generator=gen, device=device)
        t0 = time.perf_counter()
        # the cycle must never wait for the device: any synchronising call
        # inside it raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            cur, par, l_t, m = cycle(cur, gen, par, order, l_t, 1.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        print(f"  cycle {c}: {seconds[-1] * 1e3 / n:.3f} ms/step, l_t {l_t.item():.3f}, "
              f"contigs {int(m.n_contigs[-1])}, nuisance accepted "
              f"{int(m.success.sum())}/{n}")
    launches = scorer.n_launches
    return dict(state=state, scorer=scorer, cur=cur, par=par, l0=l0, l_t=l_t,
                seconds=seconds, launches=launches, n=n, nb=nb,
                catalogue=dict(catalogue_wrapper().launches.by_key()), step=step_launches(),
                rows=rows_launches(), io=io_launches())


def dense_main_checks(r, n_cycles):
    """Launch count, invariants, carried == rescored, a rising likelihood;
    prints the step rates."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState, check_invariants
    from graal_tpu_torch.entry import DELTA

    n, scorer = r["n"], r["scorer"]
    steps = n_cycles * n
    want_launches = 1 + 2 * steps
    print(f"  kernel launches: {r['launches']} (path implies 1 + 2 x {steps} = "
          f"{want_launches})")
    check(r["launches"] == want_launches,
          f"kernel launches {r['launches']} != {want_launches}")
    print(f"  catalogue launches: {r['catalogue']} (one C1 a step: {steps})")
    check(r["catalogue"] == {"em": steps}, f"C1 launches {r['catalogue']} != {steps}")
    want_io_launches(r["path"], r["io"], steps, want_launches, n_cycles)
    check(check_invariants(r["cur"], raise_on_error=False) == [],
          "final state violates the invariants")
    rescored = scorer(GenomeState(*[x[None] for x in r["cur"]]), r["par"])[0]
    check(torch.equal(rescored, r["l_t"]),
          f"carried l_t {r['l_t'].item()!r} != rescored {rescored.item()!r}")
    check(r["l_t"].item() > r["l0"].item(),
          f"likelihood did not rise: {r['l0'].item()} -> {r['l_t'].item()}")
    total_s = sum(r["seconds"])
    steady_s = sum(r["seconds"][1:])
    per_step = mcmc.n_slots(r["nb"], DELTA)
    print(f"  l_t {r['l0'].item():.3f} -> {r['l_t'].item():.3f} "
          f"(carried == rescored, bit for bit)")
    print(f"  ms/step {total_s * 1e3 / steps:.4f} (all cycles), "
          f"{steady_s * 1e3 / (steps - n):.4f} (cycles 2-{n_cycles})")
    print(f"  candidate genomes scored per second ({per_step} per step): "
          f"{per_step * steps / total_s:.1f} (all), "
          f"{per_step * (steps - n) / steady_s:.1f} (cycles 2-{n_cycles})")


def check_same_run(r, r2):
    import torch

    same = all(torch.equal(a, b) for a, b in zip(r["cur"], r2["cur"]))
    check(same and torch.equal(r["l_t"], r2["l_t"]),
          "a second run with the same seed gave a different result")
    print("  second run with the same seed: identical final state and l_t")


def phase_main(device, n_bins=384):
    import numpy as np
    from graal_tpu_torch.core.state import derive_prev_next, dist_inter_genome
    from graal_tpu_torch.entry import problem

    print(f"main path: {N_CYCLES} EM cycles, nuisance sampling on, f_t = 1")

    def build(dev):
        return problem(n_bins=n_bins, device=dev)

    r = main_path_run(device, build, N_CYCLES)
    n = r["n"]
    r["path"] = "dense_main"
    dense_main_checks(r, N_CYCLES)
    CATALOGUE_PATHS["dense_main"] = r["catalogue"]
    check(r["rows"] == {}, f"the dense main path launched G1-G3: {r['rows']}")
    want_step_launches("dense main", r["step"], N_CYCLES * n)
    init_prev, init_next = derive_prev_next(r["state"])
    # every bin has 3 sub-fragments (orientable); nothing is skipped
    dist = dist_inter_genome(r["cur"], init_prev, init_next, np.ones(n, np.int32),
                             np.ones(n, bool), np.zeros(n, bool))
    print(f"  n_contigs {int(r['cur'].n_contigs())} (true 16), "
          f"dist_inter_genome vs truth {dist:.4f}")
    check_same_run(r, main_path_run(device, build, N_CYCLES))
    return r["launches"]


def with_inactive_copy(state, f):
    """``state`` with the repeat copy ``f`` deactivated."""
    activ = state.activ.clone()
    activ[f] = 0
    return state._replace(activ=activ)


def phase_repeat_kernel(device, n_bins=384, large_bins=LARGE_BINS, small_bins=24):
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.entry import repeat_problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer, params_vector
    from graal_tpu_torch.ops.repeat_cuda import RepeatScorer

    print("repeat kernel B3 vs plain:")
    state, table, params, obs, nb = repeat_problem(n_bins=n_bins, device=device)
    scorer = make_dense_scorer(table, obs, device)
    check(isinstance(scorer, RepeatScorer), "a repeat table did not get the B3 scorer")
    print(f"  repeat problem: {state.n_frags} fragments, K = {table.n_subs} copy rows on "
          f"S = {table.n_data_sub} data subs, max_copies {nb.max_copies}, "
          f"{mcmc.n_slots(nb, DELTA)} candidates per step")
    rep = state.rep.cpu()
    frag = torch.arange(state.n_frags)
    copies = torch.nonzero((rep == 1) & (frag >= n_bins))[:, 0].tolist()
    originals = torch.nonzero((rep == 1) & (frag < n_bins))[:, 0].tolist()
    circ = circularised(state, int(state.id_c[originals[0]]))
    check(int(circ.circ[originals[0]]) == 1, "the circularised contig holds no repeat copy")
    bases = [("true", state, copies[0], True),
             ("deactivated copy", with_inactive_copy(state, copies[1]), copies[1], True),
             ("exploded", mcmc.explode_genome(state), originals[3], True),
             ("circular holding a copy", circ, originals[0], True)]
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err, batches = check_bases(scorer, table, params, nb, bases, gen)

    pvec = params_vector(params, scorer.log_nfpb)
    vecs = scorer.sub_vectors(batches[0])
    timing = {}
    for v in (vecs, [x[:1].contiguous() for x in vecs]):
        label = f"B={v[0].shape[0]} S={scorer.s}"
        t = timed(lambda: scorer.launch(*v, pvec), 50, lambda: scorer.plain(*v, pvec), 3)
        timing[label] = with_share(t, repeat_bound(scorer, v, pvec))
        print(f"  time {label} K={scorer.k}: {fmt_time(t)}; {fmt_bound(timing[label])}")

    check_three_copies(device, n_bins, gen)
    err_dense = check_copy_dense(device, gen)
    check_small_oracle(lambda dev: repeat_problem(n_bins=small_bins, n_contigs=3, n_dups=3,
                                                  device=dev), device)
    # f_a of the large batch: the first repeat copy
    err, large = check_large(lambda dev: repeat_problem(n_bins=large_bins, device=dev), device,
                             large_bins, gen)
    label = f"B={large['vecs'][0].shape[0]} S={large['scorer'].s}"
    timing[label] = with_share(large["timing"],
                               repeat_bound(large["scorer"], large["vecs"], large["pvec"]))
    print(f"  {label}: {fmt_bound(timing[label])}")
    return dict(max_abs_err=max_err, max_abs_err_s6000=err, max_abs_err_copy_dense=err_dense,
                **timing[f"B={vecs[0].shape[0]} S={scorer.s}"], by_shape=timing)


def check_three_copies(device, n_bins, gen):
    """B3 on a table where one bin is duplicated twice (a data sub with 3
    copy rows, so the general path sums 3 x 3 copy pairs): a step's
    candidates at a copy of that bin on the true and exploded genomes and
    with one of its copies deactivated, rtol 1e-4 against plain and
    bit-identical alone and in batch."""
    import numpy as np
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.entry import repeat_problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    copies = [2] + [1] * 11
    state, table, params, obs, nb = repeat_problem(n_bins=n_bins, copies=copies, device=device)
    scorer = make_dense_scorer(table, obs, device)
    per_sub = np.diff(scorer.copy_start.cpu().numpy())
    check(per_sub.max() == 3, f"the 3-copy table has at most {per_sub.max()} copies a sub")
    print(f"  3-copy table: K = {table.n_subs} copy rows on S = {scorer.s} data subs, "
          f"{int((per_sub == 3).sum())} subs with 3 copies")
    twice = n_bins                     # the first copy-fragment: bin 5's first extra copy
    bases = [("3-copy true", state, twice, False),
             ("3-copy, one copy deactivated", with_inactive_copy(state, twice + 1), twice,
              False),
             ("3-copy exploded", mcmc.explode_genome(state), twice + 1, False)]
    check_bases(scorer, table, params, nb, bases, gen)


def check_copy_dense(device, gen, n_bins=48, copies=15):
    """B3 on a copy-dense table: bins 5 to n_bins - 6 with ``copies`` extra
    copies each, about 1,000 copy rows in the densest block of 64 data
    subs, so that an item of 13 candidates would overflow a block's shared
    memory and the wrapper caps the chunk: a step's 13 candidates at a copy
    (several chunks) and the exploded genome alone, rtol 1e-4 against
    plain, each candidate bit-identical alone and in the batch. Returns the
    max abs error."""
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import repeat_problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    state, table, params, obs, nb = repeat_problem(n_bins=n_bins, n_contigs=3,
                                                   n_dups=n_bins - 10, copies=copies,
                                                   device=device)
    scorer = make_dense_scorer(table, obs, device)
    batch = candidate_batch(state, nb, n_bins, gen, n_nb=1)
    got, err = kernel_vs_plain(scorer, batch, params, "copy-dense candidates")
    print(f"  copy-dense table: K = {table.n_subs} copy rows on S = {scorer.s} data subs, "
          f"{scorer.max_blk} in the densest 64-sub block: chunk capped at {scorer.chunk_max}")
    check(scorer.chunk_max < got.shape[0],
          f"the copy-dense table kept chunks of {scorer.chunk_max}: the cap was not exercised")
    batch_invariance(scorer, batch, params, got, "copy-dense candidates")
    _, err1 = kernel_vs_plain(scorer, GenomeState(*[x[None] for x in mcmc.explode_genome(state)]),
                              params, "copy-dense exploded genome (B=1)")
    return max(err, err1)


def phase_repeat_main(device, n_bins=384):
    from graal_tpu_torch.entry import repeat_problem

    print(f"dense repeat main path: {REPEAT_CYCLES} EM cycles, nuisance sampling on, f_t = 1")

    def build(dev):
        return repeat_problem(n_bins=n_bins, device=dev)

    r = main_path_run(device, build, REPEAT_CYCLES)
    r["path"] = "dense_repeat_main"
    dense_main_checks(r, REPEAT_CYCLES)
    CATALOGUE_PATHS["dense_repeat_main"] = r["catalogue"]
    check(r["rows"] == {}, f"the dense repeat main path launched G1-G3: {r['rows']}")
    want_step_launches("dense repeat main", r["step"], REPEAT_CYCLES * r["n"])
    print(f"  n_contigs {int(r['cur'].n_contigs())}, active fragments "
          f"{int(r['cur'].activ.sum())}/{r['n']}")
    check_same_run(r, main_path_run(device, build, REPEAT_CYCLES))
    return r["launches"]


def scale_setup(device, n_bins=SCALE_BINS):
    """The chr1-class problem on the card and its runner."""
    import torch
    from graal_tpu_torch.entry import scale_problem
    from graal_tpu_torch.scale import ScaleRunner, max_contig_subs

    t0 = time.perf_counter()
    truth, shuf, table, params, sobs = scale_problem(n_bins, device=device)
    runner = ScaleRunner(table, sobs, params)
    torch.cuda.synchronize()
    print(f"chr1-scale problem: {n_bins} fragments, {sobs.rows.shape[0]} symmetric "
          f"nnz, row_cap {sobs.row_cap}, band w {runner.w}, largest shuffled contig "
          f"{max_contig_subs(shuf, table)} subs, set-up {time.perf_counter() - t0:.1f} s")
    per = n_bins // int(truth.n_contigs())
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs,
                runner=runner, n=n_bins, runner_kw={}, drift_bound=(0.0, DRIFT_REL),
                halves=cut_truth(truth, {c: [per // 2] for c in range(int(truth.n_contigs()))}),
                tiered=cut_truth(truth, tier_cuts(truth, per)))


def cut_truth(truth, cuts):
    """The true genome (fragments in genome order, every one forward) with
    contig c cut before each position of ``cuts[c]``: the pieces keep
    their order and orientation."""
    import numpy as np
    import torch

    id_c, pos, len_bp = (x.cpu().numpy().astype(np.int64)
                         for x in (truth.id_c, truth.pos, truth.len_bp))
    first = pos == 0
    for c, at in cuts.items():
        first |= (id_c == c) & np.isin(pos, at)
    piece = np.cumsum(first) - 1
    head = np.flatnonzero(first)[piece]          # first fragment of each one's piece
    start = np.cumsum(len_bp) - len_bp
    size = np.bincount(piece)[piece]
    size_bp = np.bincount(piece, weights=len_bp).astype(np.int64)[piece]
    dev = truth.pos.device

    def t(x):
        return torch.as_tensor(x.astype(np.int32), device=dev)

    return truth._replace(id_c=t(piece), pos=t(np.arange(len(pos)) - head),
                          start_bp=t(start - start[head]), l_cont=t(size),
                          l_cont_bp=t(size_bp))


def tier_cuts(truth, per):
    """Cuts of the first true contigs (of ``per`` fragments each) that
    leave, for each tier R of CROSS_TIERS, a piece of the largest size
    whose step still runs at R (2 size + 4 <= R), up to a whole contig."""
    cuts, c = {}, 0
    for r in CROSS_TIERS:
        size = (r - 4) // 2
        if size < per:
            cuts[c] = [size]
            c += 1
    return cuts


def scale_repeat_setup(device, n_bins=EXACT_BINS, n_dups=REPEAT_DUPS):
    """The chr1-scale repeat problem on the card and its runner."""
    import torch
    from graal_tpu_torch.entry import scale_repeat_problem
    from graal_tpu_torch.scale import ScaleRunner

    t0 = time.perf_counter()
    truth, shuf, table, params, sobs, id_d = scale_repeat_problem(n_bins, n_dups,
                                                                  device=device)
    runner_kw = dict(id_d=id_d)
    runner = ScaleRunner(table, sobs, params, **runner_kw)
    torch.cuda.synchronize()
    print(f"chr1-scale repeat problem: {n_bins} data bins, {n_dups} duplicated, "
          f"{truth.n_frags} fragments, {sobs.rows.shape[0]} symmetric nnz, set-up "
          f"{time.perf_counter() - t0:.1f} s")
    # drift bound of benchmarks/bench_scale_repeats.py: max(2, 1e-5 |L|)
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs,
                runner=runner, n=truth.n_frags, n_bins=n_bins, runner_kw=runner_kw,
                drift_bound=(2.0, 1e-5))


def delta_inputs(state, nb, params, scorer, extract, f_a, gen):
    """The B4 and B2 inputs of one step of fragment f_a of ``state`` at the
    scorer's bucket, as the delta step builds them: the neighbours drawn
    from ``nb`` as the step draws them, their member rows by ``extract``
    (the step's row extraction). Returns (B4's arguments (row_start, cols,
    vals, keys), the arguments (keys,) from which the step makes its
    observed grid, B2's arguments); the keys and B2's vectors are I2's."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.delta import lift_chain

    f_a = torch.tensor(f_a, device=state.pos.device)
    ids, _ = mcmc.sample_neighbours(gen, f_a, state, nb, DELTA)
    rows, valid, _ = extract(state, f_a, ids, scorer.f_max)
    _, vec, ob, pvec = scorer.inputs(*lift_chain(state, f_a, ids, rows, valid), params,
                                     state.id_c.amax()[None])
    sobs = scorer.sobs
    b4 = (sobs.row_start, sobs.cols, sobs.vals, vec.keys)
    return b4, (vec.keys,), scorer.mini_grid_args(vec, ob, pvec)


def b4_vs_plain(grid, b4, label):
    """B4 kernel and plain version on the same inputs: bit-identical.
    Returns the kernel's grid and the largest absolute difference (0.0).
    The plain version takes the neighbours in groups of at most
    PLAIN_GRID_BYTES of grid (a neighbour's rows depend on its own keys
    only), so that the kernel's grid, the step's and the plain one's fit
    together at M = 20, R = 16,384."""
    import torch

    ob_k = grid.launch(*b4)
    keys = b4[3]
    m, r = keys.shape
    group = max(1, PLAIN_GRID_BYTES // (4 * r * r))
    err = 0.0
    for a in range(0, m, group):
        ob_p = grid.plain(*b4[:3], keys[a:a + group])
        torch.cuda.synchronize()
        check(torch.equal(ob_k[a:a + group], ob_p),
              f"{label}: B4 kernel differs from its plain version")
        err = max(err, (ob_k[a:a + group] - ob_p).abs().max().item())
        del ob_p
    live = keys >= 0
    shared = sum(int(row.sum()) - len(torch.unique(k[row])) for k, row in zip(keys, live))
    # counted a neighbour at a time: a count over the whole (M, R, R) grid
    # takes int64 scratch of its size
    nonzero = sum(int(torch.count_nonzero(g)) for g in ob_k)
    print(f"  B4 {label}: M={m} R={r}, {int(live.sum())} keys with a window: bit-identical, "
          f"{nonzero} nonzero cells, sum {sum(g.sum().item() for g in ob_k):.0f}, "
          f"{shared} keys shared by copies")
    return ob_k, err


def b2_vs_plain(grid, args, label, dll_ulp=False):
    """B2 kernel and plain version on the same inputs; the kernel's count
    of (half tile, candidate) pairs of each class equal to the plain
    classifier's (the empty ones past a neighbour's live extent are drawn
    by no item); returns (the kernel's scores, max abs score error, max
    abs dll error, the plain classes). With ``dll_ulp`` a delta may also
    differ from the plain one by one f32 ulp of the plain delta where that
    ulp exceeds DLL_ATOL (|dll| >= 2^19): both are f64 differences rounded
    to f32 once, and f64 totals that differ in their last f32 partials'
    rounding can round a delta there to neighbouring f32 values."""
    import numpy as np
    import torch
    from graal_tpu_torch.ops.mini_grid_cuda import EMPTY

    counted = torch.zeros(3, dtype=torch.int32, device=args[0].device)
    s_k, d_k = grid.launch(*args, class_counts=counted)
    s_p, d_p = grid.plain(*args)
    cls, n = mini_classes(args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(s_k).all() & torch.isfinite(d_k).all()),
          f"{label}: non-finite B2 scores")
    err = (s_k.double() - s_p.double()).abs()
    rel = (err / s_p.double().abs().clamp_min(1e-30)).max().item()
    dll_diff = (d_k.double() - d_p.double()).abs()
    dll_err = dll_diff.max().item()
    excess = dll_err - DLL_ATOL
    if dll_ulp:
        ulp = torch.as_tensor(np.spacing(d_p.abs().cpu().numpy()), device=d_p.device).double()
        excess = (dll_diff - torch.clamp_min(ulp, DLL_ATOL)).max().item()
        print(f"  B2 {label}: |dll| up to {d_p.abs().max().item():.6g}, gate max({DLL_ATOL}, "
              f"one f32 ulp of the plain delta), largest excess over the gate {excess:.6g}")
    m, c, r = args[0].shape
    total = sum(n)
    print(f"  B2 {label}: M={m} C={c} R={r} max_abs_err={err.max().item():.6g} "
          f"max_rel_err={rel:.3g} dll max_abs_err={dll_err:.6g} "
          f"(|score| up to {s_p.abs().max().item():.6g}); (half tile, candidate) classes of "
          f"{total}: empty {n[0] / total:.4f}, band-free {n[1] / total:.4f}, band "
          f"{n[2] / total:.4f}")
    check(rel <= RTOL, f"{label}: B2 kernel vs plain rel err {rel} > {RTOL}")
    check(excess <= 0, f"{label}: B2 dll error {dll_err} > {DLL_ATOL}"
          + (" and one f32 ulp" if dll_ulp else ""))
    k = counted.tolist()
    check(k[1:] == n[1:] and k[EMPTY] <= n[EMPTY],
          f"{label}: the kernel's classes {k} differ from the plain classifier's {n}")
    return s_k, err.max().item(), dll_err, cls


def check_delta_kernels(sc, scorer, extract, frags, gen, want_m):
    """B4 bit-identical and B2 within RTOL / DLL_ATOL of their plain
    versions on the step inputs of the fragments ``frags``, and the step's
    observed grid equal to B4's; every B2 neighbour and genome
    bit-identical alone and in its batch; both timed at f_max 1,024, B4
    also as the whole production of the step's masked observed grid from
    the D rows and their activity (keys and kernel). Returns the kernels'
    records."""
    import torch

    b2_err, b4_err, first = 0.0, 0.0, None
    for f_a in frags:
        b4, rows_act, args = delta_inputs(sc["shuf"], sc["runner"].nb, sc["params"],
                                          scorer, extract, f_a, gen)
        check(args[0].shape[0] == want_m,
              f"f_a={f_a}: {args[0].shape[0]} neighbour slots, the path has {want_m}")
        ob_k, err = b4_vs_plain(scorer.obs_grid_kernel, b4, f"f_a={f_a}")
        b4_err = max(b4_err, err)
        check(torch.equal(args[5], ob_k), f"f_a={f_a}: the step's observed grid is not B4's")
        s_k, err, _, cls = b2_vs_plain(scorer.mini_grid, args, f"f_a={f_a}")
        b2_err = max(b2_err, err)
        if first is None:
            first = (b4, rows_act, args, s_k, cls)
    # each genome alone, and each neighbour alone, as in its batch
    b4, rows_act, args, s_k, cls = first
    m, c, _ = args[0].shape
    for a in range(m):
        alone = scorer.mini_grid.launch(*[x[a:a + 1].contiguous() for x in args])[0]
        check(torch.equal(alone, s_k[a:a + 1]), f"neighbour {a} alone differs from its batch")
    for g in range(c):
        alone = scorer.mini_grid.launch(*[x[:1, g:g + 1].contiguous() for x in args[:5]],
                                        args[5][:1].contiguous(), args[6][:1].contiguous())[0]
        check(torch.equal(alone, s_k[:1, g:g + 1]), f"genome {g} alone differs from its batch")
    print(f"  B2: {m} neighbours and {c} genomes bit-identical alone and in the batch")

    t2 = with_share(timed(lambda: scorer.mini_grid.launch(*args), 50,
                          lambda: scorer.mini_grid.plain(*args), 5), mini_bound(args, cls))
    print(f"  time B2 R={args[0].shape[2]} M={m} C={c}: {fmt_time(t2)}; {fmt_bound(t2)}")
    t4 = with_share(timed(lambda: scorer.obs_grid_kernel.launch(*b4), 50,
                          lambda: scorer.obs_grid_kernel.plain(*b4), 10), obsgrid_bound(b4))
    grid = timed(lambda: scorer.obs_grid(*rows_act), 50)
    r = b4[3].shape[1]
    print(f"  time B4 R={r} M={m}: {fmt_time(t4)}; {fmt_bound(t4)}")
    print(f"  time of the step's masked observed grid (B4 on I2's keys): {fmt_time(grid)}")
    return dict(ll_mini=dict(max_abs_err=b2_err, classes=class_shares(cls), **t2),
                obsgrid=dict(max_abs_err=b4_err, **t4, grid_ms=grid["ms"],
                             grid_device_ms=grid["device_ms"]))


def check_b4_collisions(sc, r=F_MAX):
    """B4 bit-identical to plain on R keys of the observed map of which
    half crowd the fullest buckets of the kernel's table (long probe runs,
    for inserts and lookups) and half are a run of consecutive rows, so
    that their windows hit many keys."""
    import numpy as np
    import torch
    from graal_tpu_torch.ops import obsgrid_cuda
    from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid

    sobs = sc["sobs"]
    n = sobs.n
    log2cap = obsgrid_cuda.log2_capacity(r)
    buckets = obsgrid_cuda.bucket(np.arange(n, dtype=np.int64), log2cap)
    fill = np.bincount(buckets, minlength=1 << log2cap)
    run = np.arange(n // 2, n // 2 + r // 2)
    by_fill = np.lexsort((buckets, -fill[buckets]))   # the fullest buckets' keys, bucket by bucket
    pool = by_fill[~np.isin(by_fill, run)][: r - len(run)]
    keys = np.random.default_rng(SEED).permutation(np.concatenate([run, pool])).astype(np.int32)
    keys = torch.as_tensor(keys, device=sobs.cols.device)[None]
    b4_vs_plain(WindowObsGrid(), (sobs.row_start, sobs.cols, sobs.vals, keys),
                f"colliding keys ({len(pool)} keys in {len(np.unique(buckets[pool]))} of "
                f"{1 << log2cap} buckets)")


def phase_delta_kernels(device, sc, frags=(7, 31_337, 77_777)):
    """B4 and B2 on the repeat-free delta path's inputs: one genome-length
    extraction for the 5 neighbour slots (extract_rows_union), keys of the
    CSR map by sub row; B4 on colliding keys; and both at every tier of the
    ladder."""
    import torch
    from graal_tpu_torch.core import delta

    print(f"delta kernels vs plain ({sc['n']} fragments, shuffled start):")
    # a scorer with its own kernel wrappers: these launches are not the
    # main path's
    scorer = delta.make_delta_scorer(sc["table"], None, F_MAX, sobs=sc["sobs"])
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = check_delta_kernels(sc, scorer, delta.extract_rows_union, frags, gen,
                              want_m=sc["runner"].nb.max_copies * (DELTA + 1))
    check_b4_collisions(sc)
    b2, b4 = tiers(sc, gen, out)
    out["ll_mini"]["tiers"] = b2
    out["obsgrid"]["tiers"] = b4
    out["ll_mini"]["max_abs_err"] = max([out["ll_mini"]["max_abs_err"]] + [
        t["max_abs_err"] for t in b2.values()])
    return out


def frag_fitting(state, r):
    """The fragment whose contig is the largest that half of bucket ``r``
    holds, so that a step's mini grid at R = r is mostly real rows."""
    import numpy as np
    from graal_tpu_torch.scale import contig_frags_per_frag

    sizes = contig_frags_per_frag(state)
    return int(np.argmax(np.where(sizes <= r // 2, sizes, -1)))


def delta_path_vs_plain(label, scorer, extract, bases, nb, params):
    """B4 (bit-identical) and B2 (RTOL, DLL_ATOL) against their plain
    versions through the wrappers a path ran (``scorer``'s), on one step's
    inputs at the scorer's bucket for each of ``bases`` ((name, genome,
    f_a)); the step's observed grid must be B4's. Returns (B2's max abs
    score error, B4's max abs error)."""
    import torch

    gen = torch.Generator(device=bases[0][1].pos.device).manual_seed(SEED)
    b2_err = b4_err = 0.0
    for name, base, f_a in bases:
        b4, _, args = delta_inputs(base, nb, params, scorer, extract, f_a, gen)
        tag = f"{label}, {name}, f_max={scorer.f_max} f_a={f_a}"
        ob_k, err = b4_vs_plain(scorer.obs_grid_kernel, b4, tag)
        b4_err = max(b4_err, err)
        check(torch.equal(args[5], ob_k), f"{tag}: the step's observed grid is not B4's")
        _, err, _, _ = b2_vs_plain(scorer.mini_grid, args, tag)
        b2_err = max(b2_err, err)
    return b2_err, b4_err


def tiers(sc, gen, at_flagship):
    """B2 and B4 against their plain versions (B4 bit-identical) and timed
    at every tier R of the ScaleRunner ladder (5 neighbour slots, 14
    genomes), on the step inputs of the fragment whose contig is the
    largest that half the tier holds, so the mini grid is mostly real rows:
    of the shuffled start up to 4,096, of the genome cut to fill each tier
    (``sc["tiered"]``) at 8,192 and 16,384, where peak memory is printed
    too. Returns ({R: B2 record}, {R: B4 record}), the flagship tier's
    from its phase."""
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.scale import contig_frags_per_frag

    b2, b4 = {}, {}
    for r in TIERS:
        if r == F_MAX:
            b2[r] = dict(at_flagship["ll_mini"])
            b4[r] = {k: v for k, v in at_flagship["obsgrid"].items() if k != "tiers"}
            continue
        # the shuffled start has no contig that fills a top tier: there the
        # genome of pieces cut to fill each tier
        genome = sc["tiered"] if r in TOP_TIERS else sc["shuf"]
        f_a = frag_fitting(genome, r)
        sc_r = delta.make_delta_scorer(sc["table"], None, r, sobs=sc["sobs"])
        peak = PeakMemory()
        b4_args, _, args = delta_inputs(genome, sc["runner"].nb, sc["params"], sc_r,
                                        delta.extract_rows_union, f_a, gen)
        label = (f"tier R={r} f_a={f_a} (contig of "
                 f"{contig_frags_per_frag(genome)[f_a]} fragments)")
        _, err4 = b4_vs_plain(sc_r.obs_grid_kernel, b4_args, label)
        print_b4_plan(sc_r.obs_grid_kernel, b4_args[3])
        _, err, _, cls = b2_vs_plain(sc_r.mini_grid, args, label)
        n_iter = min(200, max(5, 200 * 1024 * 1024 // (r * r)))
        n_plain = 2 if r < 8192 else 1
        t = with_share(timed(lambda: sc_r.mini_grid.launch(*args), n_iter,
                             lambda: sc_r.mini_grid.plain(*args), n_plain),
                       mini_bound(args, cls))
        print(f"  time B2 R={r} M={args[0].shape[0]}: {fmt_time(t)}; {fmt_bound(t)}")
        b2[r] = dict(max_abs_err=err, classes=class_shares(cls), **t)
        if r == TOP_TIERS[-1]:
            err = max(err, b2_circular(sc, genome, sc_r, f_a, gen, label))
        t = with_share(timed(lambda: sc_r.obs_grid_kernel.launch(*b4_args), n_iter,
                             lambda: sc_r.obs_grid_kernel.plain(*b4_args), n_plain),
                       obsgrid_bound(b4_args))
        print(f"  time B4 R={r} M={args[0].shape[0]}: {fmt_time(t)}; {fmt_bound(t)}")
        b4[r] = dict(max_abs_err=err4, **t)
        if r in TOP_TIERS:
            b2[r]["peak_gb"] = b4[r]["peak_gb"] = peak.read(f"tier R={r}")[0]
        del b4_args, args
    return b2, b4


def class_shares(cls):
    """{empty, band_free, band: share of the (half tile, candidate) pairs}."""
    import torch

    n = torch.bincount(cls.flatten().long(), minlength=3).tolist()
    return dict(zip(("empty", "band_free", "band"), (x / sum(n) for x in n)))


def print_b4_plan(grid, keys):
    """B4's launch plan for these keys: every warp of a block has a row
    buffer, of ``width`` columns."""
    m, r = keys.shape
    rows, width, log2cap = grid.plan_for(keys.device, r, m)
    print(f"  B4 plan R={r} M={m}: 8 warps a block, each with a row buffer of {width} "
          f"columns ({-(-r // width)} ranges a row), {rows} rows a block, "
          f"{-(-r // rows) * m} blocks, a table of 2^{log2cap}")


def b2_circular(sc, genome, scorer, f_a, gen, label):
    """B2 against its plain version (scores to RTOL, deltas to DLL_ATOL or
    one f32 ulp, the classes) on one step's inputs of ``genome`` with
    f_a's contig circularised, at the scorer's tier: cutting the circle of
    5,000 fragments moves a score by ~5e5, whose f32 ulp is 0.0625. Returns
    the max abs score error."""
    from graal_tpu_torch.core import delta

    circ = circularised(genome, int(genome.id_c[f_a]))
    _, _, args = delta_inputs(circ, sc["runner"].nb, sc["params"], scorer,
                              delta.extract_rows_union, f_a, gen)
    check(bool((args[2] == 1.0).any()), f"{label}: no circular row in the circularised batch")
    return b2_vs_plain(scorer.mini_grid, args, f"{label}, contig circularised", dll_ulp=True)[1]


def route_times(fn, budget_s=2.0):
    """One output of fn() and its cost: ms per call as called and
    synchronised, on the host clock ("wall_ms"), and on the device alone
    ("device_ms", :func:`device_ms`), over as many calls as fit in about
    ``budget_s`` (at least 1), after the first call (the warm-up); the
    peak device memory of that first call ("peak_gb", and "call_gb" above
    what was held before it)."""
    import torch

    mem = PeakMemory()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak_gb, call_gb = mem.read()
    n_iter = max(1, min(20, int(budget_s / max(first, 1e-3))))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_iter
    return out, dict(wall_ms=wall, device_ms=device_ms(fn, n_iter, n_warm=0), n_iter=n_iter,
                     peak_gb=peak_gb, call_gb=call_gb)


def phase_crossover(sc):
    """5c. The delta step's two scoring routes timed against each other on
    the same inputs: ``DeltaScorer.score`` with band_w None (B4 + B2) and
    with the runner's band (B4 + the banded expected mass in plain torch),
    one step of 5 neighbour slots of the fragment whose contig fills half
    the tier, at R = 2,048-16,384, and of 4 chains (M = 20, each chain its
    own parameters and draws) at 8,192. Each route's wall and device ms
    and peak memory; the deltas of the two routes within the reference's
    banded-vs-grid tolerance; and the card's routing
    (``core.delta.effective_band_w`` on this device) must send each tier to
    the route whose wall time is the lesser."""
    import torch
    from graal_tpu_torch.core import delta, mcmc
    from graal_tpu_torch.scale import contig_frags_per_frag

    table, sobs, nb, w = sc["table"], sc["sobs"], sc["runner"].nb, sc["runner"].w
    genome = sc["tiered"]
    dev = genome.pos.device
    sizes = contig_frags_per_frag(genome)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print(f"delta routes at {sc['n']} fragments: DeltaScorer.score with band_w None "
          f"(B4 + B2) and {w} (B4 + banded mass, plain torch)")
    out = []
    for r, n_chains in [(t, 1) for t in CROSS_TIERS] + [(TOP_TIERS[0], CHAINS)]:
        f_a = frag_fitting(genome, r)
        states = type(genome)(*[x.expand(n_chains, -1).contiguous() for x in genome])
        params = sc["params"] if n_chains == 1 else chain_params(sc["params"], n_chains)
        fa = torch.full((n_chains,), f_a, device=dev)
        u = torch.rand((n_chains, nb.pk.shape[1]), generator=gen, device=dev)
        ids, _ = mcmc.sample_neighbours(u, fa, states, nb, DELTA)
        rows, valid, over = delta.extract_rows_union(states, fa, ids, r)
        args = (states, fa, ids, rows, valid, over, params, states.id_c.amax(-1))
        rec = dict(R=r, M=n_chains * ids.shape[1], f_a=f_a, contig=int(sizes[f_a]))
        dll = {}
        for route, band_w in (("grid", None), ("banded", w)):
            scorer = delta.make_delta_scorer(table, None, r, sobs=sobs, band_w=band_w)
            dll[route], rec[route] = route_times(lambda: scorer.score(*args)[0])
            del scorer
        diff = (dll["grid"].double() - dll["banded"].double()).abs()
        excess = (diff - BAND_ATOL - BAND_RTOL * dll["banded"].double().abs()).max().item()
        rec["dll_max_abs_diff"] = diff.max().item()
        routed = "grid" if delta.effective_band_w(w, table, r) is None else "banded"
        rec["routed"] = routed
        g, b = rec["grid"], rec["banded"]
        print(f"  R={r} M={rec['M']} (contig of {rec['contig']} fragments): grid wall "
              f"{g['wall_ms']:.4f} ms, device {g['device_ms']:.4f} ms, peak {g['peak_gb']:.3f} "
              f"GB; banded wall {b['wall_ms']:.4f} ms, device {b['device_ms']:.4f} ms, peak "
              f"{b['peak_gb']:.3f} GB; wall ratio {b['wall_ms'] / g['wall_ms']:.2f}; dll max "
              f"|grid - banded| {rec['dll_max_abs_diff']:.6g}; routed to {routed}")
        print(f"    {json.dumps(rec)}")
        check(excess <= 0, f"R={r} M={rec['M']}: grid and banded deltas differ beyond rtol "
              f"{BAND_RTOL}, atol {BAND_ATOL} (by {excess})")
        out.append(rec)
        del args, dll, states, rows
    for rec in out:
        faster = "grid" if rec["grid"]["wall_ms"] <= rec["banded"]["wall_ms"] else "banded"
        check(rec["routed"] == faster, f"R={rec['R']} M={rec['M']}: the card's rule routes "
              f"to {rec['routed']}, but {faster} was faster")
    return out


def phase_repeat_delta_kernels(device, sc):
    """B4 and B2 on the repeat delta path's own inputs: the single-copy
    part of the repeat engine v2 (its plain scorer: CSR rows of the
    single-copy map keyed by data bin, so two copies of a bin share a key),
    member rows extracted per neighbour (extract_rows_each), 10 neighbour
    slots a step (max_copies 2); at a repeat copy, an original of a
    duplicated bin and a contig extremity of the shuffled start."""
    import numpy as np
    import torch
    from graal_tpu_torch.core import delta, delta_repeats

    shuf, n_bins = sc["shuf"], sc["n_bins"]
    print(f"repeat delta kernels vs plain ({sc['n']} fragments, shuffled start):")
    # a repeat engine with its own kernel wrappers: these launches are not
    # the main path's
    engine = delta_repeats.make_repeat_delta_scorer_v2(sc["table"], F_MAX, sc["sobs"],
                                                       shuf.rep)
    rep = shuf.rep.cpu().numpy()
    rng = np.random.default_rng(SEED)
    frags = (n_bins + 7, int(np.nonzero(rep[:n_bins] == 1)[0][3]),
             int(rng.permutation(extremities(shuf))[0]))
    gen = torch.Generator(device=device).manual_seed(SEED)
    return check_delta_kernels(sc, engine.plain, delta.extract_rows_each, frags, gen,
                               want_m=sc["runner"].nb.max_copies * (DELTA + 1))


def extremities(state):
    import numpy as np

    pos, l_cont = state.pos.cpu().numpy(), state.l_cont.cpu().numpy()
    return np.nonzero((pos == 0) | (pos == l_cont - 1))[0]


def exactness_steps(label, step, anchor, shuf, params, order, rep=None):
    """Single delta steps at the fragments ``order``, each followed by a
    full sparse re-anchor: the carried likelihood must be within
    max(0.5, 1e-6 |L|) of it (benchmarks/check_exactness.py:55), and some
    committed step must move it by more than that, or the gate was not
    exercised. With ``rep``, some such step must have a repeat fragment as
    fA or fB."""
    import torch

    gen = torch.Generator(device=shuf.pos.device).manual_seed(SEED)
    cur, l_t = shuf, anchor(shuf, params)
    worst, bad, moved, above_tol, rep_above, max_dl = 0.0, 0, 0, 0, 0, 0.0
    for f_a in order:
        new, l_new, (op, fb, _) = step(cur, gen, params, l_t, int(f_a), 1.0)
        l_re = anchor(new, params)
        err = abs(l_new.item() - l_re.item())
        tol = max(0.5, 1e-6 * abs(l_re.item()))
        dl = abs(l_new.item() - l_t.item())
        bad += err > tol
        worst = max(worst, err)
        moved += int(op) >= 0
        above_tol += dl > tol
        if rep is not None and int(op) >= 0 and dl > tol:
            rep_above += int(rep[int(f_a)]) == 1 or int(rep[int(fb)]) == 1
        max_dl = max(max_dl, dl)
        cur, l_t = new, l_re   # re-anchor: isolate each step's error
    stats = dict(n_fragments=shuf.n_frags, f_max=F_MAX, steps=len(order), moves=moved,
                 steps_dl_above_tol=int(above_tol), max_abs_dl=max_dl, bad_steps=int(bad),
                 worst_err=worst, L=l_t.item())
    if rep is not None:
        stats["repeat_steps_dl_above_tol"] = rep_above
    print(f"{label}: {json.dumps(stats)}")
    check(bad == 0, f"{bad} of {len(order)} delta steps drifted beyond max(0.5, 1e-6 |L|)")
    check(above_tol > 0, "no step committed a likelihood change above the gate's "
          "tolerance: the exactness gate was not exercised")
    check(rep is None or rep_above > 0, "no committed step at a repeat fragment moved the "
          "likelihood above the gate's tolerance")


def phase_exactness(device, n_bins=EXACT_BINS, steps=10):
    """Twin of benchmarks/check_exactness.py, stepping at contig
    extremities of the shuffled start, where a step joins pieces."""
    import numpy as np
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.entry import scale_problem
    from graal_tpu_torch.scale import ScaleRunner

    _, shuf, table, params, sobs = scale_problem(n_bins, device=device)
    runner = ScaleRunner(table, sobs, params)
    step = delta.make_delta_em_step(table, None, runner.nb, DELTA, F_MAX, sobs=sobs,
                                    band_w=runner.w)
    order = np.random.default_rng(SEED).permutation(extremities(shuf))[:steps]
    exactness_steps("per-step exactness", step, runner.anchor_fn(), shuf, params, order)


def phase_repeat_exactness(device, n_bins=EXACT_BINS, n_dups=EXACT_REPEAT_DUPS):
    """Twin of benchmarks/check_exactness_repeats.py, stepping where a move
    changes something: 4 repeat copies, 3 originals of duplicated bins and
    3 contig extremities of the shuffled start."""
    import numpy as np
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.entry import scale_repeat_problem
    from graal_tpu_torch.scale import ScaleRunner

    truth, shuf, table, params, sobs, id_d = scale_repeat_problem(n_bins, n_dups,
                                                                  device=device)
    runner = ScaleRunner(table, sobs, params, id_d=id_d)
    step = delta.make_delta_em_step(table, None, runner.nb, DELTA, F_MAX, sobs=sobs,
                                    rep=truth.rep)
    rep = truth.rep.cpu().numpy()
    rng = np.random.default_rng(SEED)
    copies = np.arange(n_bins, truth.n_frags)
    originals = np.nonzero(rep[:n_bins] == 1)[0]
    order = np.concatenate([rng.permutation(copies)[:4], rng.permutation(originals)[:3],
                            rng.permutation(extremities(shuf))[:3]])
    exactness_steps("repeat per-step exactness", step, runner.anchor_fn(), shuf, params,
                    order, rep=rep)


def scale_main_run(sc):
    """One seeded run of the delta main path: cycle_for(1024, 4) for
    MAIN_STEPS steps from the shuffled start, no synchronising call."""
    import torch

    runner, shuf, params = sc["runner"], sc["shuf"], sc["params"]
    device = shuf.pos.device
    cycle = runner.cycle_for(F_MAX, DELTA, rep=shuf.rep)
    gen = torch.Generator(device=device).manual_seed(SEED)
    order = torch.randperm(sc["n"], generator=gen, device=device)[:MAIN_STEPS]
    l0 = runner.anchor_fn()(shuf, params)
    torch.cuda.synchronize()
    runner.obs_grid.n_launches = runner.mini_grid.n_launches = 0
    catalogue_wrapper().n_launches = step_wrapper().n_launches = corr_wrapper().n_launches = 0
    rows_wrapper().n_launches = inputs_wrapper().n_launches = 0
    vectors_wrapper().n_launches = scan_wrapper().n_launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cur, l_t, out = cycle(shuf, gen, params, order, l0, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(cur=cur, l0=l0, l_t=l_t, out=out, seconds=seconds,
                launches=(runner.mini_grid.n_launches, runner.obs_grid.n_launches),
                catalogue=dict(catalogue_wrapper().launches.by_key()), step=step_launches(),
                corr=corr_launches(), rows=rows_launches(), io=io_launches())


def phase_scale_main(sc, label="delta main path"):
    import torch
    from graal_tpu_torch.core.mcmc import n_slots

    print(f"{label}: cycle_for({F_MAX}, {DELTA}), {MAIN_STEPS} steps from the "
          f"shuffled {sc['n']}-fragment start")
    r = scale_main_run(sc)
    l_re = sc["runner"].anchor_fn()(r["cur"], sc["params"])
    drift = abs(r["l_t"].item() - l_re.item())
    floor, rel = sc["drift_bound"]
    bound = max(floor, rel * abs(l_re.item()))
    ops = r["out"][1]
    print(f"  l_t {r['l0'].item():.3f} -> {r['l_t'].item():.3f}, re-anchored {l_re.item():.3f}, "
          f"drift {drift:.6g} (bound max({floor}, {rel} |L|) = {bound:.3f})")
    check(drift < bound, f"carried l_t drifted {drift} from the re-anchor")
    print(f"  moves committed {int((ops >= 0).sum())}/{MAIN_STEPS}, overflowed slots "
          f"{int(r['out'][3].sum())}, n_contigs {int(r['out'][4][-1])}")
    print(f"  launches: ll_mini {r['launches'][0]}, obsgrid {r['launches'][1]} "
          f"(path implies one of each per step: {MAIN_STEPS})")
    check(r["launches"] == (MAIN_STEPS, MAIN_STEPS), f"launches {r['launches']}")
    print(f"  catalogue launches: {r['catalogue']} (one C1 a step: {MAIN_STEPS})")
    check(r["catalogue"] == {"em": MAIN_STEPS}, f"C1 launches {r['catalogue']}")
    CATALOGUE_PATHS[label.replace(" ", "_")] = r["catalogue"]
    want_step_launches(label, r["step"], MAIN_STEPS, delta=True)
    want_rows_launches(label.replace(" ", "_"), r["rows"], MAIN_STEPS)
    want_io_launches(label.replace(" ", "_"), r["io"], MAIN_STEPS, 0, 1)
    if sc["table"].has_repeats:
        want_corr_launches("repeat_delta_main", r["corr"], MAIN_STEPS)
    else:
        check(r["corr"] == {}, f"{label}: a repeat-free path launched F1 / F2: {r['corr']}")
    per_step = n_slots(sc["runner"].nb, DELTA)
    ms = r["seconds"] * 1e3 / MAIN_STEPS
    print(f"  {ms:.4f} ms/step, {per_step * MAIN_STEPS / r['seconds']:.1f} candidate "
          f"genomes/s ({per_step} per step; first run)")
    r2 = scale_main_run(sc)
    same = all(torch.equal(a, b) for a, b in zip(r["cur"], r2["cur"])) and \
        torch.equal(r["l_t"], r2["l_t"]) and \
        all(torch.equal(a, b) for a, b in zip(r["out"], r2["out"]))
    check(same, "a second run with the same seed gave a different result")
    ms2 = r2["seconds"] * 1e3 / MAIN_STEPS
    print(f"  second run with the same seed: identical; {ms2:.4f} ms/step, "
          f"{per_step * MAIN_STEPS / r2['seconds']:.1f} candidate genomes/s")
    return r["launches"]


def phase_runner(sc, n_cycles=1, steps=512):
    import torch
    from graal_tpu_torch.scale import ScaleRunner

    print(f"ScaleRunner.run ({sc['n']} fragments): {n_cycles} cycle(s) x {steps} "
          f"extremity-first steps, f_max_min 256, nuisance sampling on")
    # a fresh runner (same neighbour table): its kernel counts are this run's
    runner = ScaleRunner(sc["table"], sc["sobs"], sc["params"], nb=sc["runner"].nb,
                         **sc["runner_kw"])
    l0 = runner.anchor_fn()(sc["shuf"], sc["params"]).item()
    counted = count_cycles(runner)
    torch.cuda.synchronize()
    corr_wrapper().n_launches = rows_wrapper().n_launches = inputs_wrapper().n_launches = 0
    t0 = time.perf_counter()
    final, params, m = runner.run(sc["shuf"], n_cycles=n_cycles, steps_per_cycle=steps,
                                  order_mode="extremity", f_max_min=256, sample_param=True,
                                  init_truth=sc["truth"], seed=SEED + 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"  likelihood {l0:.3f} -> {m['likelihood']}, n_contigs "
          f"{int(sc['shuf'].n_contigs())} -> {m['n_contigs']}, tiers {m['tiers']}, "
          f"overflow {m['overflow']}, dist_init_genome {m['dist_init_genome']}")
    print(f"  params fact {m['fact']}, slope {m['slope']}, d_max {m['d_max']}, "
          f"v_inter {m['v_inter']}")
    print(f"  launches: ll_mini {runner.mini_grid.n_launches}, obsgrid "
          f"{runner.obs_grid.n_launches}; {seconds:.1f} s in all")
    check(m["likelihood"][-1] > l0, f"likelihood did not rise: {l0} -> {m['likelihood']}")
    check(runner.mini_grid.n_launches > 0 and runner.obs_grid.n_launches > 0,
          "the runner launched no delta kernel")
    check(all(abs(x) < float("inf") for x in m["likelihood"]), "non-finite likelihood")
    want_rows_launches("repeat_runner" if sc["table"].has_repeats else "runner", rows_launches(),
                       counted["steps"])    # one scoring call a step, retries included
    if sc["table"].has_repeats:
        want_corr_launches("repeat_runner", corr_launches(), counted["steps"])
    else:
        check(corr_launches() == {}, "a repeat-free runner launched F1 / F2")
    del final, params


@contextlib.contextmanager
def banded_calls():
    """Counts the calls of ``DeltaScorer._banded_dll`` (the plain banded
    expected mass) inside the block, by every scorer: yields a one-item
    list."""
    from graal_tpu_torch.core.delta import DeltaScorer

    inner = DeltaScorer._banded_dll
    calls = [0]

    def counted(self, *a):
        calls[0] += 1
        return inner(self, *a)

    DeltaScorer._banded_dll = counted
    try:
        yield calls
    finally:
        DeltaScorer._banded_dll = inner


def count_cycles(runner):
    """Wrap ``runner.cycle_for`` (a runner's, or the ScaleRunner class's
    for the runners made after) so that every cycle chunk it hands out
    counts its steps and tiers and keeps the carried likelihood it
    returned: the record it returns (steps, tiers, l_t)."""
    rec = dict(steps=0, tiers=set(), l_t=None)
    inner = runner.cycle_for

    def counting(cyc, f_max):
        def counted(state, rng, params, order, l_t, f_t):
            out = cyc(state, rng, params, order, l_t, f_t)
            rec["steps"] += order.shape[-1]
            rec["tiers"].add(f_max)
            rec["l_t"] = out[1]
            return out

        return counted

    if isinstance(runner, type):
        def cycle_for(self, f_max, delta_, rep=None):
            return counting(inner(self, f_max, delta_, rep), f_max)
    else:
        def cycle_for(f_max, delta_, rep=None):
            return counting(inner(f_max, delta_, rep), f_max)

    runner.cycle_for = cycle_for
    return rec


def top_run(sc, start, steps):
    """One seeded ScaleRunner.run cycle of ``steps`` extremity-first steps
    from ``start`` (no nuisance step, so the cycle ends in its re-anchor),
    on a fresh runner whose counts are this run's."""
    import torch
    from graal_tpu_torch.scale import ScaleRunner

    runner = ScaleRunner(sc["table"], sc["sobs"], sc["params"], nb=sc["runner"].nb)
    rec = count_cycles(runner)
    peak = PeakMemory()
    rows_wrapper().n_launches = inputs_wrapper().n_launches = 0
    t0 = time.perf_counter()
    with banded_calls() as banded:
        final, _, m = runner.run(start, n_cycles=1, steps_per_cycle=steps,
                                 order_mode="extremity", f_max_min=TIERS[0], sample_param=False,
                                 init_truth=sc["truth"], seed=SEED + 2, progress=False)
    torch.cuda.synchronize()
    return dict(final=final, m=m, seconds=time.perf_counter() - t0, banded=banded[0],
                launches=(runner.mini_grid.n_launches, runner.obs_grid.n_launches),
                rows=rows_launches(),
                peak_gb=peak.read(f"ScaleRunner.run from {int(start.n_contigs())} contigs")[0],
                **rec)


def phase_runner_top(sc, steps=None):
    """8b. ScaleRunner.run at the top tiers: one cycle of ``steps``
    extremity-first steps from the truth cut into 40 pieces of 2,500
    fragments (tier 8,192) and from the truth itself (contigs of 5,000,
    tier 16,384), twice each. Each run launches one B2 and one B4 a step
    (every chunk's steps counted, retries and wrap-padding included) and
    never the banded mass; the carried likelihood within DRIFT_REL |L| of
    the cycle's re-anchor; the invariants; the second run identical."""
    import torch
    from graal_tpu_torch.core.state import check_invariants

    steps = steps or RUNNER_TOP_STEPS
    out = {}
    for name, start, tier in (("40 pieces", sc["halves"], TOP_TIERS[0]),
                              ("truth", sc["truth"], TOP_TIERS[1])):
        print(f"ScaleRunner.run at {sc['n']} fragments from {name} "
              f"({int(start.n_contigs())} contigs): 1 cycle x {steps} extremity-first steps")
        runs = [top_run(sc, start, steps) for _ in range(2)]
        a = runs[0]
        m = a["m"]
        l_re = m["likelihood"][-1]
        drift = abs(float(a["l_t"]) - l_re)
        bound = DRIFT_REL * abs(l_re)
        print(f"  tiers {sorted(a['tiers'])} (metrics {m['tiers']}), {a['steps']} steps run, "
              f"launches ll_mini {a['launches'][0]}, obsgrid {a['launches'][1]}, banded mass "
              f"calls {a['banded']}; likelihood carried {float(a['l_t']):.3f}, re-anchored "
              f"{l_re:.3f}, drift {drift:.6g} (bound {bound:.3f}); n_contigs "
              f"{int(start.n_contigs())} -> {m['n_contigs']}, overflow {m['overflow']}, "
              f"dist {m['dist_init_genome']}; cycle {m['cycle_s'][-1]:.3f} s and "
              f"{runs[1]['m']['cycle_s'][-1]:.3f} s ({a['seconds']:.3f} s with set-up)")
        check(sorted(a["tiers"]) == [tier], f"{name}: tiers {sorted(a['tiers'])}, not {tier}")
        check(a["launches"] == (a["steps"], a["steps"]),
              f"{name}: launches {a['launches']} for {a['steps']} steps")
        check(a["banded"] == 0, f"{name}: {a['banded']} calls of the banded mass")
        want_rows_launches(f"run_top_{tier}", a["rows"], a["steps"])
        check(drift < bound, f"{name}: carried likelihood drifted {drift} > {bound}")
        check(check_invariants(a["final"], raise_on_error=False) == [], f"{name}: invariants")
        b = runs[1]
        same = all(torch.equal(x, y) for x, y in zip(a["final"], b["final"])) and \
            m["likelihood"] == b["m"]["likelihood"] and float(a["l_t"]) == float(b["l_t"])
        check(same, f"{name}: a second run with the same seed gave a different result")
        print("  second run with the same seed: identical")
        out[f"run_top_{tier}"] = dict(
            launches=a["launches"], steps=a["steps"], banded_calls=a["banded"], tier=tier,
            drift=drift, likelihood=l_re, n_contigs=m["n_contigs"][-1],
            cycle_s=[r["m"]["cycle_s"][-1] for r in runs], peak_gb=[r["peak_gb"] for r in runs])
        del runs, a, b
    return out


def cli(argv):
    """One command of the port's CLI, in this process (``cli.execute`` is
    the body of ``cli.main``; it returns what the command drove, so the
    kernels' launch counts can be read). Each command builds its own
    scorers, whose counts start at 0."""
    from graal_tpu_torch import cli as cli_mod

    print(f"  $ python -m graal_tpu_torch.cli {' '.join(argv)}", flush=True)
    return cli_mod.execute(argv)


def run_argv(ds, out, *extra):
    return ["run", ds, "--size", "3", "--level", "2", "--fasta", os.path.join(ds, "genome.fa"),
            "--out", out, *extra]


def check_outputs(out, names):
    missing = [n for n in names if not os.path.exists(os.path.join(out, n))]
    check(not missing, f"{out}: missing outputs {missing}")


RUN_OUTPUTS = ["0list_likelihood.txt", "0list_n_contigs.txt", "0list_dist_init_genome.txt",
               "0list_fact.txt", "0list_slope.txt", "0list_d_max.txt", "0list_d_nuc.txt",
               "0list_success.txt", "0list_mean_len.txt", "0list_mutations.txt",
               "params.json", "genome.fasta", "info_frags.txt", "assembly_stats.json",
               "checkpoint.npz"]


def dense_path_vs_plain(label, runner, asm, f_a):
    """The kernel of a run's dense scorer (B1, or B3 for a repeat table)
    against its plain version on the run's own table and observed map, at
    rtol 1e-4: the candidates of one step at ``f_a`` of the run's final
    genome and of its exploded start, and each genome alone (B = 1, also
    held to the dense likelihood); each candidate bit-identical alone and
    in its batch. Returns the max abs error."""
    import torch
    from graal_tpu_torch.core import mcmc

    gen = torch.Generator(device=asm.state.pos.device).manual_seed(SEED)
    bases = [(f"{label} final", asm.state, f_a, True),
             (f"{label} exploded start", mcmc.explode_genome(asm.state), f_a, True)]
    err, _ = check_bases(runner.scorer, runner.table, asm.params, runner.nb, bases, gen)
    return err


def phase_dataset(root):
    """9. A synthetic dataset at the flagship width and its pyramid."""
    from graal_tpu_torch.io import native_io

    print(f"dataset: simulate {DATASET_BINS} level-0 fragments on {DATASET_CONTIGS} "
          f"contigs, pyramid of 3 levels")
    ds = os.path.join(root, "ds")
    t0 = time.perf_counter()
    cli(["simulate", ds, "--bins", str(DATASET_BINS), "--contigs", str(DATASET_CONTIGS),
         "--seed", str(SEED)])
    t1 = time.perf_counter()
    pyr = cli(["pyramid", ds, "--size", "3"])
    t2 = time.perf_counter()
    for lv in range(3):
        lev = pyr.get_level(lv)
        print(f"  level {lv}: {lev.n_frags} fragments, {lev.sparse.nnz} nnz")
    check(native_io.load.cache_info().currsize == 1,
          "the pyramid build did not load the native contact parser")
    print(f"  native parser {native_io.library_path().name} loaded; simulate {t1 - t0:.1f} s, "
          f"pyramid {t2 - t1:.1f} s")
    # the low-coverage filter removes ~16% of the level-0 fragments
    n1, n2 = pyr.get_level(1).n_frags, pyr.get_level(2).n_frags
    check(n1 >= 0.75 * DATASET_BINS / 3 and n2 >= 0.75 * DATASET_BINS / 9,
          f"level sizes {n1}, {n2}")
    return ds


def phase_cli_run(ds, root):
    """9a-9c. Dense run through B1, resume, replay."""
    import filecmp

    import numpy as np
    import torch
    from graal_tpu_torch.core.state import GenomeState, check_invariants

    print(f"cli run (dense, B1): {CLI_CYCLES} EM cycles at level 2, nuisance sampling on")
    o1 = os.path.join(root, "o1")
    t0 = time.perf_counter()
    runner, asm = cli(run_argv(ds, o1, "--cycles", str(CLI_CYCLES)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = runner.state.n_frags
    launches = runner.scorer.n_launches
    want = 1 + 2 * CLI_CYCLES * n
    print(f"  K = {runner.table.n_subs} subs, {n} bins; ll_dense launches {launches} "
          f"(path implies 1 + 2 x {CLI_CYCLES * n} = {want})")
    check(launches == want, f"ll_dense launches {launches} != {want}")
    check(check_invariants(asm.state, raise_on_error=False) == [], "final state invariants")
    lik = asm.metrics["likelihood"]
    rescored = runner.scorer(GenomeState(*[x[None] for x in asm.state]), asm.params)[0].item()
    check(rescored == lik[-1], f"carried l_t {lik[-1]!r} != rescored {rescored!r}")
    check(lik[-1] > lik[0], f"likelihood did not rise: {lik[0]} -> {lik[-1]}")
    check_outputs(o1, RUN_OUTPUTS)
    cycle_s = runner.timer.report()["em_cycle"]["mean_ms"] / 1e3
    print(f"  l_t {lik[0]:.3f} -> {lik[-1]:.3f} (carried == rescored), n_contigs "
          f"{asm.metrics['n_contigs'][-1]}, dist {asm.metrics['dist_init_genome'][-1]:.4f}")
    print(f"  wall {cycle_s:.3f} s/cycle ({cycle_s * 1e3 / n:.3f} ms/step); whole command "
          f"{wall:.1f} s; {len(RUN_OUTPUTS)} output files")
    err = dense_path_vs_plain("cli run", runner, asm, 7 % n)

    print("cli run --resume: 1 cycle, then resumed to 2")
    o2 = os.path.join(root, "o2")
    cli(run_argv(ds, o2, "--cycles", "1"))
    r2, _ = cli(run_argv(ds, o2, "--cycles", str(CLI_CYCLES), "--resume"))
    check(r2.scorer.n_launches == 2 * n, f"resumed run launches {r2.scorer.n_launches}")
    with np.load(os.path.join(o1, "checkpoint.npz")) as a, \
            np.load(os.path.join(o2, "checkpoint.npz")) as b:
        check(sorted(a.files) == sorted(b.files), "checkpoint entries differ")
        diff = [k for k in a.files if not np.array_equal(a[k], b[k])]
    check(not diff, f"resumed checkpoint differs from the uninterrupted run's: {diff}")
    print(f"  checkpoint of the resumed run == uninterrupted run's, bit for bit "
          f"({len(a.files)} entries: state, params, generator, l_t, metrics)")

    print("cli replay of the run's mutation log")
    o3 = os.path.join(root, "o3")
    _, state, ll = cli(["replay", ds, os.path.join(o1, "0list_mutations.txt"), "--size", "3",
                        "--level", "2", "--fasta", os.path.join(ds, "genome.fa"),
                        "--out", o3])
    check(all(torch.equal(a, b) for a, b in zip(state, asm.state)),
          "replayed state != the run's final state")
    check(filecmp.cmp(os.path.join(o1, "genome.fasta"), os.path.join(o3, "genome.fasta"),
                      shallow=False), "replayed genome.fasta differs from the run's")
    print(f"  replayed state == final state; genome.fasta byte-identical; replayed "
          f"loglik {ll.item():.3f} (fitted params)")
    return dict(launches=launches, cycle_s=cycle_s, max_abs_err=err)


def phase_cli_delta(ds, root):
    """9d. Delta run through B2 + B4, anchored by B1."""
    import torch
    from graal_tpu_torch.core import delta, mcmc, sparse
    from graal_tpu_torch.core.state import GenomeState, check_invariants

    print("cli run --scoring delta (B2 + B4, B1 anchor): 1 cycle, no nuisance")
    o4 = os.path.join(root, "o4")
    rows_wrapper().n_launches = inputs_wrapper().n_launches = 0
    t0 = time.perf_counter()
    runner, asm = cli(run_argv(ds, o4, "--cycles", "1", "--scoring", "delta",
                               "--no-sample-param"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = runner.state.n_frags
    got = (runner.mini_grid.n_launches, runner.obs_grid.n_launches, runner.scorer.n_launches)
    print(f"  launches: ll_mini {got[0]}, obsgrid {got[1]}, ll_dense {got[2]} "
          f"(path implies {n}, {n}, 2)")
    check(got == (n, n, 2), f"delta run launches {got}")
    want_rows_launches("cli_run_delta", rows_launches(), n)
    lls, anchor = asm.metrics["likelihood"][-1], asm.metrics["anchor"][-1]
    drift = abs(lls - anchor)
    print(f"  carried {lls:.3f}, re-anchored {anchor:.3f}, drift {drift:.6g} "
          f"(bound {DRIFT_REL} |L| = {DRIFT_REL * abs(anchor):.3f})")
    check(drift <= DRIFT_REL * abs(anchor), f"delta run drifted {drift}")
    check(check_invariants(asm.state, raise_on_error=False) == [], "final state invariants")
    check_outputs(o4, RUN_OUTPUTS)
    cycle_s = runner.timer.report()["em_cycle"]["mean_ms"] / 1e3
    print(f"  wall {cycle_s:.3f} s/cycle ({cycle_s * 1e3 / n:.3f} ms/step); whole command "
          f"{wall:.1f} s")
    # the run's wrappers against their plain versions at each bucket it ran,
    # on its own observed map, on the exploded start and the final genome
    sobs = sparse.sparse_from_dense(runner.obs, device=runner.device)
    b2_err = b4_err = 0.0
    for bucket in runner.delta_buckets:
        scorer = delta.make_delta_scorer(runner.table, runner.obs, bucket, sobs=sobs,
                                         obs_grid=runner.obs_grid, mini_grid=runner.mini_grid)
        bases = [("exploded start", mcmc.explode_genome(asm.state), 7 % n),
                 ("final", asm.state, frag_fitting(asm.state, scorer.f_max))]
        errs = delta_path_vs_plain("cli run --scoring delta", scorer, delta.extract_rows_union,
                                   bases, runner.nb, asm.params)
        b2_err, b4_err = max(b2_err, errs[0]), max(b4_err, errs[1])
    _, dense_err = kernel_vs_plain(runner.scorer, GenomeState(*[x[None] for x in asm.state]),
                                   asm.params, "cli run --scoring delta, B1 anchor (B=1)")
    # G1-G3 against their plain versions at the run's bucket on its final genome
    gen = torch.Generator(device=runner.device).manual_seed(SEED + 72)
    case = rows_case(f"cli_run_delta_{min(runner.delta_buckets)}", dict(runner=runner),
                     min(runner.delta_buckets), states=GenomeState(*[x[None] for x in asm.state]))
    rows_shape(case, gen)
    # I1 and I2 against their plain versions at that bucket (the dataset's
    # own sub rows, 1 to 3 a fragment)
    inputs_shape(case, delta.make_delta_scorer(runner.table, None, case["f_max"], sobs=sobs),
                 asm.params, gen)
    return dict(mini=got[0], obs=got[1], dense=got[2], cycle_s=cycle_s, mini_err=b2_err,
                obs_err=b4_err, dense_err=dense_err)


def phase_cli_scale(ds, root):
    """9e. The scale command (from_dataset + ScaleRunner.run) through B2 + B4."""
    import math

    from graal_tpu_torch.core import delta, mcmc
    from graal_tpu_torch.core.state import check_invariants
    from graal_tpu_torch.scale import ScaleRunner

    print("cli scale: level 1, 1 cycle of 512 extremity-first steps, f_max_min 64")
    o5 = os.path.join(root, "o5")
    rows_wrapper().n_launches = inputs_wrapper().n_launches = 0
    inner = ScaleRunner.cycle_for
    counted = count_cycles(ScaleRunner)
    try:
        runner, final, m = cli(["scale", ds, "--size", "3", "--level", "1", "--cycles", "1",
                                "--steps-per-cycle", "512", "--order", "extremity",
                                "--f-max-min", "64", "--fasta", os.path.join(ds, "genome.fa"),
                                "--out", o5])
    finally:
        ScaleRunner.cycle_for = inner
    want_rows_launches("cli_scale", rows_launches(), counted["steps"])
    got = (runner.mini_grid.n_launches, runner.obs_grid.n_launches)
    print(f"  {final.n_frags} bins over {runner.table.n_data_sub} data subs; launches: "
          f"ll_mini {got[0]}, obsgrid {got[1]}; tiers {m['tiers']}")
    check(got[0] > 0 and got[1] > 0, "the scale command launched no delta kernel")
    check(math.isfinite(m["likelihood"][-1]), f"final_loglik {m['likelihood'][-1]}")
    check(check_invariants(final, raise_on_error=False) == [], "final state invariants")
    check_outputs(o5, ["0list_likelihood.txt", "0list_f_max.txt", "0list_d_nuc.txt",
                       "genome.fasta", "info_frags.txt", "assembly_stats.json",
                       "checkpoint.npz"])
    print(f"  final_loglik {m['likelihood'][-1]:.3f}, n_contigs {m['n_contigs'][-1]}, "
          f"wall {m['cycle_s'][-1]:.3f} s/cycle")
    # the runner's wrappers against their plain versions at every tier the
    # run used, each scorer built as the runner's cycle builds it
    b2_err = b4_err = 0.0
    for tier in sorted({t for ts in m["tiers"] for t in ts}):
        scorer = delta.make_delta_scorer(
            runner.table, None, tier, sobs=runner.sobs,
            band_w=delta.effective_band_w(runner.w, runner.table, tier),
            obs_grid=runner.obs_grid, mini_grid=runner.mini_grid)
        bases = [("exploded start", mcmc.explode_genome(final), 7),
                 ("final", final, frag_fitting(final, scorer.f_max))]
        errs = delta_path_vs_plain("cli scale", scorer, delta.extract_rows_union, bases,
                                   runner.nb, runner.params)
        b2_err, b4_err = max(b2_err, errs[0]), max(b4_err, errs[1])
    return dict(mini=got[0], obs=got[1], cycle_s=m["cycle_s"][-1], mini_err=b2_err,
                obs_err=b4_err)


def phase_cli_repeats(ds, root):
    """9f. A dense run with --allow-repeats on the dataset with one
    fragment's contacts amplified tenfold: B3 scores it."""
    import shutil

    from graal_tpu_torch.core.state import check_invariants

    print("cli run --allow-repeats --sampler em,mtm (B3): 1 cycle a stage on the dataset "
          f"with fragment {AMPLIFIED_FRAG}'s contacts amplified tenfold")
    dsr = os.path.join(root, "ds_rep")
    shutil.copytree(ds, dsr, ignore=shutil.ignore_patterns("pyramids"))
    amplify_fragment(os.path.join(dsr, "abs_fragments_contacts_weighted.txt"),
                     AMPLIFIED_FRAG, 9)
    o6 = os.path.join(root, "o6")
    runner, asm = cli(run_argv(dsr, o6, "--cycles", "1", "--allow-repeats", "--sampler",
                               "em,mtm"))
    n = runner.state.n_frags
    launches = runner.scorer.n_launches
    shapes = runner.scorer.launch_shapes
    print(f"  {len(runner.duplications)} repeated bins, {n} fragments on "
          f"{runner.table.n_data_sub} data subs; ll_repeat launches {launches} "
          f"(path implies 1 + 2 x {n} a stage), batch sizes {dict(shapes)}")
    check(runner.table.has_repeats, "no repeat detected on the amplified dataset")
    check(type(runner.scorer).__name__ == "RepeatScorer", "the repeat table is not on B3")
    check(launches == 2 * (1 + 2 * n), f"ll_repeat launches {launches}")
    check(shapes[(MTM_SLOTS, runner.table.n_subs)] == 2 * n,
          f"the MTM passes did not each launch B3 once at B = {MTM_SLOTS}")
    stages = check_stages(runner, n)
    check_outputs(o6, RUN_OUTPUTS)
    # f_a: the first repeat copy
    err = dense_path_vs_plain("cli run --allow-repeats", runner, asm, runner.n_bins)
    err_mtm, _ = mtm_pass_vs_plain("cli run --allow-repeats, MTM pass", runner, asm,
                                   runner.n_bins)
    return dict(launches=launches, max_abs_err=max(err, err_mtm), stages=stages,
                scale=cli_scale_repeats(dsr, root))


def cli_scale_repeats(dsr, root, steps=256):
    """9f's dataset through ``scale --allow-repeats`` at level 2: the repeat
    table goes to the repeat delta engine, whose copy corrections launch
    F1 / F2 once a scoring call (every cycle chunk's steps counted, retries
    included); a finite likelihood, the invariants and outputs."""
    import math

    from graal_tpu_torch.core.state import check_invariants
    from graal_tpu_torch.scale import ScaleRunner

    print(f"cli scale --allow-repeats: level 2, 1 cycle of {steps} extremity-first steps")
    o7 = os.path.join(root, "o7")
    corr_wrapper().n_launches = rows_wrapper().n_launches = inputs_wrapper().n_launches = 0
    inner = ScaleRunner.cycle_for
    counted = count_cycles(ScaleRunner)
    try:
        runner, final, m = cli(["scale", dsr, "--size", "3", "--level", "2", "--cycles", "1",
                                "--steps-per-cycle", str(steps), "--order", "extremity",
                                "--f-max-min", "64", "--allow-repeats", "--fasta",
                                os.path.join(dsr, "genome.fa"), "--out", o7])
    finally:
        ScaleRunner.cycle_for = inner
    got = corr_launches()
    c_max = int(runner.table.data_id.bincount().amax())
    print(f"  {final.n_frags} fragments over {runner.table.n_data_sub} data subs, repeat table "
          f"{runner.table.has_repeats} (c_max {c_max}); final_loglik {m['likelihood'][-1]:.3f}, "
          f"tiers {m['tiers']}")
    check(runner.table.has_repeats, "scale --allow-repeats found no repeat")
    want_corr_launches("cli_scale_repeats", got, counted["steps"])
    want_rows_launches("cli_scale_repeats", rows_launches(), counted["steps"])
    check(math.isfinite(m["likelihood"][-1]), f"final_loglik {m['likelihood'][-1]}")
    check(check_invariants(final, raise_on_error=False) == [], "final state invariants")
    check_outputs(o7, ["0list_likelihood.txt", "genome.fasta", "checkpoint.npz"])
    return dict(launches=got, steps=counted["steps"], cycle_s=m["cycle_s"][-1])


def amplify_fragment(pairs, frag, extra):
    """Append ``extra`` more copies of every raw contact pair of 1-based
    fragment ``frag`` (tests/test_pipeline.py's repeat recipe)."""
    with open(pairs) as fh:
        lines = fh.readlines()
    key = str(frag)
    hits = [ln for ln in lines[1:] if key in ln.split("\t")[:2]]
    with open(pairs, "a") as fh:
        fh.writelines(hits * extra)


@contextlib.contextmanager
def launch_calls(name):
    """Count the calls of ``launch`` of the scorer class ``name``
    (DenseScorer or RepeatScorer) while the block runs, by (B, K); the
    launches themselves are unchanged. A captured cycle calls ``launch``
    at its eager first step and capture only, so this proves that no
    kernel of the class ran at all (phase 10d); the counts of a run's
    launches are its scorer's ``n_launches`` and ``launch_shapes``, which
    replays advance."""
    import collections

    from graal_tpu_torch.ops import likelihood_cuda, repeat_cuda

    cls = {"DenseScorer": likelihood_cuda.DenseScorer,
           "RepeatScorer": repeat_cuda.RepeatScorer}[name]
    seen = collections.Counter()
    launch = cls.launch

    def counted(self, *args):
        seen[tuple(args[0].shape)] += 1
        return launch(self, *args)

    cls.launch = counted
    try:
        yield seen
    finally:
        cls.launch = launch


def check_stages(runner, n, before=None):
    """Every sampler stage of a CLI run: 1 + 2 x steps launches of the
    run's scorer, the invariants, and the carried likelihood equal to the
    scorer's rescoring of the stage's genome bit for bit. Returns each
    stage's wall s/cycle and accept rate; ``before``: s/cycle by stage to
    print beside them."""
    import torch
    from graal_tpu_torch.core.state import GenomeState, check_invariants

    out, prev = {}, 0
    for st in runner.stages:
        launches, prev = st["launches"] - prev, st["launches"]
        asm = st["assembly"]
        check(launches == 1 + 2 * n, f"{st['name']}: {launches} launches != 1 + 2 x {n}")
        check(check_invariants(asm.state, raise_on_error=False) == [],
              f"{st['name']}: final state invariants")
        rescored = runner.scorer(GenomeState(*[x[None] for x in asm.state]), asm.params)[0]
        check(torch.equal(rescored, st["l_t"]),
              f"{st['name']}: carried l_t {st['l_t'].item()!r} != rescored {rescored.item()!r}")
        acc = asm.metrics.get("accepts")
        rate = sum(acc) / len(acc) if acc else None
        out[st["name"]] = dict(s_per_cycle=st["seconds"], accept_rate=rate)
        print(f"  {st['name']}: {launches} launches, l_t {st['l_t'].item():.3f} (carried == "
              f"rescored), {st['seconds']:.3f} s/cycle ({st['seconds'] * 1e3 / n:.3f} ms/step)"
              + ("" if before is None else
                 f" against {before[st['name']]} before the sampler cycles were captured")
              + ("" if rate is None else f", accept rate {rate:.4f}"))
    return out


def mtm_batch(state, jump, f_a):
    """Flat (delta + 2) x 13 batch of one MTM / MH pass: the MH catalogue
    of f_a against its neighbour set."""
    import torch
    from graal_tpu_torch.core import mtm
    from graal_tpu_torch.core.candidates import N_CANDIDATES, mh_candidates
    from graal_tpu_torch.core.state import GenomeState

    f_a = torch.tensor(f_a, device=state.pos.device)
    ids, _ = mtm._neighbour_set(state, f_a, jump)
    cands = mh_candidates(state, f_a, ids)
    m = ids.shape[0]
    return GenomeState(*[x.reshape(m * N_CANDIDATES, -1).contiguous() for x in cands])


def mtm_pass_vs_plain(label, runner, asm, f_a, n_time=0):
    """The run's dense kernel (B1 or B3) against its plain version on one
    MTM pass's candidates of the final genome (B = 91), each candidate
    bit-identical alone and in the batch; timed when ``n_time``. Returns
    (max abs error, timing or None)."""
    from graal_tpu_torch.ops.likelihood_cuda import params_vector

    scorer = runner.scorer
    batch = mtm_batch(asm.state, runner.jump_table(MTM_DELTA), f_a)
    got, err = kernel_vs_plain(scorer, batch, asm.params, f"{label} (f_a={f_a})")
    batch_invariance(scorer, batch, asm.params, got, label)
    if not n_time:
        return err, None
    vecs = scorer.sub_vectors(batch)
    pvec = params_vector(asm.params, scorer.log_nfpb)
    t = with_share(timed(lambda: scorer.launch(*vecs, pvec), n_time,
                         lambda: scorer.plain(*vecs, pvec), 5), dense_bound(vecs, pvec))
    print(f"  time B={got.shape[0]} K={scorer.k}: {fmt_time(t)}; {fmt_bound(t)}")
    return err, t


def phase_cli_stages(ds, root):
    """10a. run --sampler em,mtm,mh: EM, MTM and MH on B1."""
    from graal_tpu_torch.core.mcmc import n_slots

    print("cli run --sampler em,mtm,mh (B1): 1 cycle a stage at level 2, nuisance on in EM")
    out = os.path.join(root, "o10a")
    move_wrapper().n_launches = 0
    runner, asm = cli(run_argv(ds, out, "--cycles", "1", "--sampler", "em,mtm,mh"))
    n, k = runner.state.n_frags, runner.table.n_subs
    want_move_launches("cli_run_mtm", move_launches(), 2 * n)   # an MTM and an MH cycle
    launches = runner.scorer.n_launches
    shapes = runner.scorer.launch_shapes
    em_b = n_slots(runner.nb, runner.cfg.sampler.n_neighbours)
    want = {(1, k): 3 + n, (em_b, k): n, (MTM_SLOTS, k): 4 * n}
    print(f"  K = {k}, {n} bins; ll_dense launches {launches} (path implies 3 + 6 x {n} = "
          f"{3 + 6 * n}); batch sizes {dict(shapes)}")
    check(launches == 3 + 6 * n, f"ll_dense launches {launches}")
    check(dict(shapes) == want, f"launch shapes {dict(shapes)} != {want}")
    stages = check_stages(runner, n, EAGER_CYCLES_S)
    check_outputs(out, RUN_OUTPUTS)
    err, t = mtm_pass_vs_plain("cli run MTM pass", runner, asm, 7 % n, n_time=50)
    return dict(launches=launches, max_abs_err=err, B91=t, stages=stages)


def phase_cli_tempered(ds, root):
    """10b. run --sampler tempered --chains 4: every chain scored in one B1
    launch a step."""
    import torch
    from graal_tpu_torch.core.mcmc import n_slots
    from graal_tpu_torch.core.state import GenomeState, check_invariants
    from graal_tpu_torch.ops.likelihood_cuda import params_vector

    print(f"cli run --sampler tempered --chains {CHAINS} (B1): 1 cycle at level 2")
    out = os.path.join(root, "o10b")
    runner, asm = cli(run_argv(ds, out, "--cycles", "1", "--sampler", "tempered",
                               "--chains", str(CHAINS)))
    scorer = runner.scorer
    shapes = scorer.launch_shapes
    n, k = runner.state.n_frags, runner.table.n_subs
    launches = scorer.n_launches
    b = CHAINS * n_slots(runner.nb, runner.cfg.sampler.n_neighbours)
    print(f"  ll_dense launches {launches} (path implies 1 + {n}); batch sizes {dict(shapes)}")
    check(launches == 1 + n, f"ll_dense launches {launches}")
    check(dict(shapes) == {(1, k): 1, (b, k): n}, f"launch shapes {dict(shapes)}")
    rescored = scorer(GenomeState(*[x[None] for x in asm.state]), asm.params)[0]
    check(torch.equal(rescored, runner.l_t),
          f"cold chain's carried l_t {runner.l_t.item()!r} != rescored {rescored.item()!r}")
    chains = [GenomeState(*[x[c] for x in runner.chain_states]) for c in range(CHAINS)]
    for c, st in enumerate(chains):
        check(check_invariants(st, raise_on_error=False) == [], f"chain {c} invariants")
    check_outputs(out, [f for f in RUN_OUTPUTS if f != "checkpoint.npz"])
    cycle_s = runner.timer.report()["tempered_cycles"]["mean_ms"] / 1e3
    print(f"  cold l_t {runner.l_t.item():.3f} (carried == rescored), chains "
          f"{[round(x, 3) for x in asm.metrics['likelihood_all_chains'][-1]]}, swaps "
          f"{asm.metrics['swap_accepts']}; {cycle_s:.3f} s/cycle "
          f"({cycle_s * 1e3 / n:.3f} ms/step; {EAGER_CYCLES_S['tempered']} before the cycle was "
          "captured)")
    # B1 vs plain on one step's candidates of the 4 chains (B = 260), timed
    gen = torch.Generator(device=asm.state.pos.device).manual_seed(SEED)
    batch = stack([candidate_batch(st, runner.nb, 7 % n, gen) for st in chains])
    got, err = kernel_vs_plain(scorer, batch, asm.params, f"{CHAINS} chains' candidates")
    batch_invariance(scorer, batch, asm.params, got, f"{CHAINS} chains' candidates")
    vecs = scorer.sub_vectors(batch)
    pvec = params_vector(asm.params, scorer.log_nfpb)
    t = with_share(timed(lambda: scorer.launch(*vecs, pvec), 50,
                         lambda: scorer.plain(*vecs, pvec), 5), dense_bound(vecs, pvec))
    print(f"  time B={b} K={k}: {fmt_time(t)}; {fmt_bound(t)}")
    return dict(launches=launches, max_abs_err=err, B260=t, cycle_s=cycle_s,
                swaps=asm.metrics["swap_accepts"])


def phase_cli_multilevel(ds, root):
    """10c. run --level 2 --to-level 1: B1 at K = 972, then K = 2,901 from
    the projected warm start."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState, check_invariants
    from graal_tpu_torch.ops.likelihood_cuda import params_vector

    print("cli run --level 2 --to-level 1 (B1): 1 EM cycle a level, nuisance on")
    out = os.path.join(root, "o10c")
    runner, asm = cli(run_argv(ds, out, "--cycles", "1", "--to-level", "1"))
    (_, r2, a2, _), (_, r1, a1, warm) = runner.levels
    shapes = r2.scorer.launch_shapes + r1.scorer.launch_shapes
    n2, n1 = r2.state.n_frags, r1.state.n_frags
    k2, k1 = r2.scorer.k, r1.scorer.k
    got = (r2.scorer.n_launches, r1.scorer.n_launches)
    b2 = mcmc.n_slots(r2.nb, 4)
    want = {(1, k2): 1 + n2, (b2, k2): n2, (1, k1): 1 + n1, (b2, k1): n1}
    print(f"  level 2: {n2} bins, K = {k2}; level 1: {n1} bins, K = {k1}; ll_dense launches "
          f"{got} (path implies {(1 + 2 * n2, 1 + 2 * n1)}); batch sizes {dict(shapes)}")
    check(got == (1 + 2 * n2, 1 + 2 * n1), f"ll_dense launches {got}")
    check(k1 > k2 and dict(shapes) == want, f"launch shapes {dict(shapes)}")
    check(check_invariants(warm, raise_on_error=False) == [], "warm start invariants")
    l_warm = r1.scorer(GenomeState(*[x[None] for x in warm]), a1.params)[0].item()
    l_expl = r1.scorer(GenomeState(*[x[None] for x in mcmc.explode_genome(warm)]),
                       a1.params)[0].item()
    print(f"  warm start {l_warm:.3f} vs exploded level-1 genome {l_expl:.3f}")
    check(l_warm > l_expl, "the projected warm start scores below the exploded genome")
    check(check_invariants(asm.state, raise_on_error=False) == [], "final state invariants")
    for r, a in ((r2, a2), (r1, a1)):
        rescored = r.scorer(GenomeState(*[x[None] for x in a.state]), a.params)[0]
        check(torch.equal(rescored, r.l_t), f"K={r.scorer.k}: carried != rescored")
    check_outputs(out, RUN_OUTPUTS)
    cycle_s = [r.timer.report()["em_cycle"]["mean_ms"] / 1e3 for r in (r2, r1)]
    print(f"  s/cycle {cycle_s[0]:.3f} (level 2), {cycle_s[1]:.3f} (level 1); l_t "
          f"{r2.l_t.item():.3f} -> level 1 {r1.l_t.item():.3f} (carried == rescored)")
    # B1 vs plain at K = 2,901 at B = 65 and B = 1, timed at B = 65
    gen = torch.Generator(device=asm.state.pos.device).manual_seed(SEED)
    err, batches = check_bases(r1.scorer, r1.table, a1.params, r1.nb,
                               [("level-1 final", a1.state, 7 % n1, True)], gen)
    vecs = r1.scorer.sub_vectors(batches[0])
    pvec = params_vector(a1.params, r1.scorer.log_nfpb)
    t = with_share(timed(lambda: r1.scorer.launch(*vecs, pvec), 20,
                         lambda: r1.scorer.plain(*vecs, pvec), 2), dense_bound(vecs, pvec))
    print(f"  time B={vecs[0].shape[0]} K={k1}: {fmt_time(t)}; {fmt_bound(t)}")
    # E1-E3 vs plain at the level-1 MTM shape (phase 3e's check)
    from graal_tpu_torch.core import mtm

    move_shape(move_case("cli_level1_mtm", "dense", "mtm", a1.state, r1.jump_table(MTM_DELTA),
                         a1.params, mtm._make_scores_for(r1.table, r1.obs, torch.float32,
                                                         r1.scorer),
                         r1.l_t, torch.arange(n1, device=a1.state.pos.device)), gen)
    return dict(launches=sum(got), max_abs_err=err, K2901=t, cycle_s=cycle_s)


def phase_cli_hic(ds, root):
    """10d. run --model hic: the broken power law in plain torch on the
    card; no kernel launches."""
    import torch
    from graal_tpu_torch.core.model_hic import HiCParams, make_hic_scorer
    from graal_tpu_torch.core.state import GenomeState, check_invariants

    print("cli run --model hic: 1 EM cycle at level 2 (plain torch scorer, no nuisance)")
    out = os.path.join(root, "o10d")
    with launch_calls("DenseScorer") as b1, launch_calls("RepeatScorer") as b3:
        runner, asm = cli(run_argv(ds, out, "--cycles", "1", "--model", "hic"))
    n = runner.state.n_frags
    print(f"  launches: ll_dense {sum(b1.values())}, ll_repeat {sum(b3.values())}")
    check(not b1 and not b3, "a kernel launched in the HiC run")
    check(isinstance(asm.params, HiCParams) and not runner.sample_param,
          "the HiC run sampled nuisance parameters")
    check(len(set(asm.metrics["fact"])) == 1, "a parameter moved in the HiC run")
    lik = asm.metrics["likelihood"]
    check(lik[-1] > lik[0], f"likelihood did not rise: {lik[0]} -> {lik[-1]}")
    check(check_invariants(asm.state, raise_on_error=False) == [], "final state invariants")
    check_outputs(out, RUN_OUTPUTS)
    cycle_s = runner.timer.report()["em_cycle"]["mean_ms"] / 1e3
    print(f"  l_t {lik[0]:.3f} -> {lik[-1]:.3f}; {cycle_s:.3f} s/cycle "
          f"({cycle_s * 1e3 / n:.3f} ms/step)")
    # one 65-candidate batch on the card and on the CPU
    gen = torch.Generator(device=asm.state.pos.device).manual_seed(SEED)
    batch = candidate_batch(asm.state, runner.nb, 7 % n, gen)
    got = runner.scorer(batch, asm.params)
    cpu_table = runner.table._replace(**{f: getattr(runner.table, f).cpu() for f in (
        "owner", "data_id", "len_kb", "accu", "prefix_kb", "suffix_kb")})
    want = make_hic_scorer(cpu_table, runner.obs)(GenomeState(*[x.cpu() for x in batch]),
                                                  HiCParams(*[x.cpu() for x in asm.params]))
    err = (got.cpu().double() - want.double()).abs()
    rel = (err / want.double().abs()).max().item()
    t = timed(lambda: runner.scorer(batch, asm.params), 10)
    print(f"  HiC scorer B={got.shape[0]} K={runner.table.n_subs}: card vs CPU max_abs_err "
          f"{err.max().item():.6g}, max_rel_err {rel:.3g}; {t['ms']:.4f} ms a call (as "
          f"called), {t['device_ms']:.4f} ms (device)")
    check(rel <= 1e-5, f"HiC scores on the card vs the CPU: rel err {rel}")
    return dict(launches=0, max_abs_err_cpu=err.max().item(), hic_ms=t, cycle_s=cycle_s)


def mtm_delta_vs_plain(label, runner, state, bucket, f_a, n_time=0):
    """The runner's B4 (bit-identical) and B2 (RTOL, DLL_ATOL) against their
    plain versions on one delta MTM pass's inputs at ``bucket``: the MH
    catalogue of f_a against its neighbour set, each neighbour on its own
    member rows. Returns (B2 error, B4 error, B2 timing or None)."""
    import torch
    from graal_tpu_torch.core import delta, mtm
    from graal_tpu_torch.core.candidates import mh_candidates

    scorer = delta.make_delta_scorer(runner.table, None, bucket, sobs=runner.sobs,
                                     obs_grid=runner.obs_grid, mini_grid=runner.mini_grid,
                                     catalogue=mh_candidates)
    f_a = torch.tensor(f_a, device=state.pos.device)
    ids, _ = mtm._neighbour_set(state, f_a, runner.jump_table(MTM_DELTA, state.n_frags))
    rows, valid, _ = delta.extract_rows_each(state, f_a, ids, scorer.f_max)
    _, vec, ob, pvec = scorer.inputs(*delta.lift_chain(state, f_a, ids, rows, valid),
                                     runner.params, state.id_c.amax()[None])
    b4 = (runner.sobs.row_start, runner.sobs.cols, runner.sobs.vals, vec.keys)
    args = scorer.mini_grid_args(vec, ob, pvec)
    tag = f"{label}, f_max={scorer.f_max} f_a={int(f_a)}"
    ob_k, err4 = b4_vs_plain(scorer.obs_grid_kernel, b4, tag)
    check(torch.equal(args[5], ob_k), f"{tag}: the step's observed grid is not B4's")
    _, err2, _, cls = b2_vs_plain(scorer.mini_grid, args, tag)
    if not n_time:
        return err2, err4, None
    t = with_share(timed(lambda: scorer.mini_grid.launch(*args), n_time,
                         lambda: scorer.mini_grid.plain(*args), 3), mini_bound(args, cls))
    m, c, r = args[0].shape
    print(f"  time B2 R={r} M={m} C={c}: {fmt_time(t)}; {fmt_bound(t)}")
    return err2, err4, dict(R=r, M=m, C=c, **t)


def scale_run_vs_plain(label, runner, final, tiers_used):
    """The runner's B2 and B4 against their plain versions at every tier a
    run used, each scorer built as the runner's cycle builds it, on the
    exploded start and the final genome. Returns (B2 error, B4 error)."""
    from graal_tpu_torch.core import delta, mcmc

    b2_err = b4_err = 0.0
    for tier in sorted(set(tiers_used)):
        scorer = delta.make_delta_scorer(
            runner.table, None, tier, sobs=runner.sobs,
            band_w=delta.effective_band_w(runner.w, runner.table, tier),
            obs_grid=runner.obs_grid, mini_grid=runner.mini_grid)
        bases = [("exploded start", mcmc.explode_genome(final), 7),
                 ("final", final, frag_fitting(final, scorer.f_max))]
        errs = delta_path_vs_plain(label, scorer, delta.extract_rows_union, bases,
                                   runner.nb, runner.params)
        b2_err, b4_err = max(b2_err, errs[0]), max(b4_err, errs[1])
    return b2_err, b4_err


def phase_cli_scale_mtm(ds, root):
    """10e. scale --mtm-cycles 1: delta MTM on B2 + B4 with the MH
    catalogue after a run."""
    import math

    from graal_tpu_torch.core import delta
    from graal_tpu_torch.core.state import check_invariants

    print("cli scale --mtm-cycles 1: level 2, 1 cycle of 256 steps, then 1 MTM cycle")
    out = os.path.join(root, "o10e")
    move_wrapper().n_launches = 0
    runner, final, m = cli(["scale", ds, "--size", "3", "--level", "2", "--cycles", "1",
                            "--steps-per-cycle", "256", "--mtm-cycles", "1", "--f-max-min",
                            "64", "--fasta", os.path.join(ds, "genome.fa"), "--out", out])
    n = final.n_frags
    want_move_launches("cli_scale_mtm", move_launches(), n)
    mm = m["mtm"]
    bucket = mm["f_max"][0]
    banded = delta.effective_band_w(runner.w, runner.table, bucket) is not None
    got = (mm["launches"]["ll_mini"], mm["launches"]["obsgrid"])
    want = (0 if banded else 2 * n, 2 * n)
    total = (runner.mini_grid.n_launches, runner.obs_grid.n_launches)
    print(f"  {n} bins; MTM at f_max {bucket}: launches ll_mini {got[0]}, obsgrid {got[1]} "
          f"(path implies two a step: {want}); the run before it {total[0] - got[0]}, "
          f"{total[1] - got[1]} on tiers {m['tiers']}")
    check(got == want and got[0] > 0, f"MTM launches {got} != {want}")
    check(math.isfinite(m["likelihood"][-1]), f"final_loglik {m['likelihood'][-1]}")
    check(check_invariants(final, raise_on_error=False) == [], "final state invariants")
    check_outputs(out, ["0list_likelihood.txt", "0list_f_max.txt", "genome.fasta",
                        "info_frags.txt", "assembly_stats.json", "checkpoint.npz"])
    print(f"  final_loglik {m['likelihood'][-1]:.3f}, accept rate {mm['accept_rate'][0]:.4f}, "
          f"MTM {mm['cycle_s'][0]:.3f} s/cycle ({mm['cycle_s'][0] * 1e3 / n:.3f} ms/step), "
          f"run {m['cycle_s'][0]:.3f} s/cycle")
    e2, e4, t = mtm_delta_vs_plain("cli scale MTM pass", runner, final, bucket, 7 % n,
                                   n_time=50)
    e2b, e4b = scale_run_vs_plain("cli scale --mtm-cycles run", runner, final, m["tiers"][0])
    return dict(mini=total[0], obs=total[1], mtm=got, mini_err=max(e2, e2b),
                obs_err=max(e4, e4b), mtm_shape=t, cycle_s=mm["cycle_s"][0],
                accept_rate=mm["accept_rate"][0])


def phase_cli_scale_multilevel(ds, root):
    """10g. scale --level 2 --to-level 1: B2 + B4 at both levels."""
    import math

    from graal_tpu_torch.core.state import check_invariants

    print("cli scale --level 2 --to-level 1: 1 cycle a level, f_max_min 64")
    out = os.path.join(root, "o10g")
    runner, final, per_level = cli(["scale", ds, "--size", "3", "--level", "2", "--to-level",
                                    "1", "--cycles", "1", "--f-max-min", "64", "--fasta",
                                    os.path.join(ds, "genome.fa"), "--out", out])
    for lv in per_level:
        la = lv["launches"]
        print(f"  level {lv['level']}: final_loglik {lv['likelihood'][-1]:.3f}, n_contigs "
              f"{lv['n_contigs'][-1]}, tiers {lv['tiers']}, launches {la}, "
              f"{lv['cycle_s'][-1]:.3f} s/cycle")
        check(la["ll_mini"] > 0 and la["obsgrid"] > 0,
              f"level {lv['level']}: B2 / B4 did not launch")
        check(math.isfinite(lv["likelihood"][-1]), f"level {lv['level']}: final_loglik")
    check([lv["level"] for lv in per_level] == [2, 1], "levels run")
    check(check_invariants(final, raise_on_error=False) == [], "final state invariants")
    check_outputs(out, ["genome.fasta", "info_frags.txt", "assembly_stats.json"])
    e2, e4 = scale_run_vs_plain("cli scale --to-level 1, level 1", runner, final,
                                per_level[-1]["tiers"][0])
    return dict(mini=sum(lv["launches"]["ll_mini"] for lv in per_level),
                obs=sum(lv["launches"]["obsgrid"] for lv in per_level), mini_err=e2,
                obs_err=e4, cycle_s=[lv["cycle_s"][-1] for lv in per_level])


def mtm_exactness_steps(label, step, anchor, shuf, params, order):
    """Single delta MTM / MH steps at the fragments ``order``, each followed
    by a full sparse re-anchor: the carried likelihood within max(0.5,
    1e-6 |L|) of it (check_exactness.py:55), and every committed genome
    valid. Returns the stats."""
    import torch
    from graal_tpu_torch.core.state import check_invariants

    gen = torch.Generator(device=shuf.pos.device).manual_seed(SEED)
    cur, l_t = shuf, anchor(shuf, params)
    worst, bad, invalid, accepted, max_dl = 0.0, 0, 0, 0, 0.0
    for f_a in order:
        new, l_new, acc, _ = step(cur, gen, params, l_t, int(f_a), 1.0)
        l_re = anchor(new, params)
        err = abs(l_new.item() - l_re.item())
        bad += err > max(0.5, 1e-6 * abs(l_re.item()))
        worst = max(worst, err)
        accepted += bool(acc)
        max_dl = max(max_dl, abs(l_new.item() - l_t.item()))
        invalid += check_invariants(new, raise_on_error=False) != []
        cur, l_t = new, l_re
    stats = dict(n_fragments=shuf.n_frags, f_max=F_MAX, steps=len(order), accepted=accepted,
                 max_abs_dl=max_dl, bad_steps=int(bad), invalid_states=invalid,
                 worst_err=worst, L=l_t.item())
    print(f"{label}: {json.dumps(stats)}")
    check(bad == 0, f"{bad} of {len(order)} steps drifted beyond max(0.5, 1e-6 |L|)")
    check(invalid == 0, f"{invalid} committed genomes violate the invariants")
    return stats


def phase_mtm_exactness(device, n_bins=EXACT_BINS, steps=MTM_EXACT_STEPS):
    """10f. Delta MTM and MH steps at f_max 1,024 on the 20k exactness twin
    and its 12-dup repeat twin (phase 6's set-ups), each re-anchored."""
    import numpy as np
    from graal_tpu_torch.core import mtm
    from graal_tpu_torch.entry import scale_problem, scale_repeat_problem
    from graal_tpu_torch.ops.mini_grid_cuda import MiniGridScorer
    from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid
    from graal_tpu_torch.scale import ScaleRunner

    rng = np.random.default_rng(SEED)
    _, shuf, table, params, sobs = scale_problem(n_bins, device=device)
    runner = ScaleRunner(table, sobs, params)
    jump = runner.jump_table(MTM_DELTA, shuf.n_frags)
    order = rng.permutation(extremities(shuf))[:steps]
    setups = [("", shuf, table, sobs, runner, dict(band_w=runner.w), order)]
    truth, shuf_r, table_r, params_r, sobs_r, id_d = scale_repeat_problem(
        n_bins, EXACT_REPEAT_DUPS, device=device)
    runner_r = ScaleRunner(table_r, sobs_r, params_r, id_d=id_d)
    rep = truth.rep.cpu().numpy()
    order_r = np.concatenate([rng.permutation(np.arange(n_bins, truth.n_frags))[:4],
                              rng.permutation(np.nonzero(rep[:n_bins] == 1)[0])[:3],
                              rng.permutation(extremities(shuf_r))[:3]])
    setups.append(("repeat ", shuf_r, table_r, sobs_r, runner_r, dict(rep=truth.rep), order_r))
    stats, launches = {}, [0, 0]
    for kind, st, tb, so, rn, kw, od in setups:
        jmp = jump if not kind else rn.jump_table(MTM_DELTA, st.n_frags)
        for variant, make in (("mtm", mtm.make_delta_mtm_step), ("mh", mtm.make_delta_mh_step)):
            grid, mini = WindowObsGrid(), MiniGridScorer()
            step = make(tb, jmp, F_MAX, so, obs_grid=grid, mini_grid=mini, **kw)
            key = f"{kind}{variant}"
            stats[key] = mtm_exactness_steps(f"{kind}delta {variant} per-step exactness", step,
                                             rn.anchor_fn(), st, rn.params, od)
            check(mini.n_launches == 2 * len(od) and grid.n_launches == 2 * len(od),
                  f"{key}: launches {mini.n_launches}, {grid.n_launches} != two a step")
            launches[0] += mini.n_launches
            launches[1] += grid.n_launches
    check(max(s["max_abs_dl"] for s in stats.values()) > 0.5,
          "no accepted delta MTM / MH step moved the likelihood beyond the gate's floor: "
          "the exactness gate was not exercised")
    return dict(stats=stats, mini=launches[0], obs=launches[1])


def phase_cli(device):
    """Phases 9-9f, 10a-10e, 10g and 11c in a temporary directory that is
    removed afterwards (10f, the exactness twins, runs after it)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="graal_cli_") as root:
        ds = phase_dataset(root)
        dense = phase("cli run", phase_cli_run, ds, root)
        delta = phase("cli delta", phase_cli_delta, ds, root)
        scale = phase("cli scale", phase_cli_scale, ds, root)
        rep = phase("cli repeats", phase_cli_repeats, ds, root)
        stages = phase("cli stages", phase_cli_stages, ds, root)
        tempered = phase("cli tempered", phase_cli_tempered, ds, root)
        multilevel = phase("cli multilevel", phase_cli_multilevel, ds, root)
        hic = phase("cli hic", phase_cli_hic, ds, root)
        scale_mtm = phase("cli scale_mtm", phase_cli_scale_mtm, ds, root)
        scale_ml = phase("cli scale_multilevel", phase_cli_scale_multilevel, ds, root)
        scale_chains = phase("cli scale_chains", phase_cli_scale_chains, ds, root)
    return dict(dense=dense, delta=delta, scale=scale, repeat=rep, stages=stages,
                tempered=tempered, multilevel=multilevel, hic=hic, scale_mtm=scale_mtm,
                scale_multilevel=scale_ml, scale_chains=scale_chains)


def chain_starts(sc, n_chains=CHAINS):
    """Distinct chain starts: the problem's shuffled start and other
    shuffles of its truth into as many pieces, stacked on a chains axis."""
    import torch
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.utils.synthetic_sparse import shuffle_genome

    pieces = int(sc["shuf"].n_contigs())
    starts = [sc["shuf"]] + [shuffle_genome(sc["truth"], pieces, seed=SEED + 100 + c)
                             for c in range(n_chains - 1)]
    return GenomeState(*[torch.stack(xs) for xs in zip(*starts)])


def chain_params(params, n_chains=CHAINS):
    """One parameter set per chain: the problem's, scaled by 1 + 0.01 c."""
    import torch
    from graal_tpu_torch.core.model import RippeParams

    return RippeParams(*[torch.stack([x * (1.0 + 0.01 * c) for c in range(n_chains)])
                         for x in params])


def chain_extremities(states, k):
    """(C,) fA of a chains step: the k-th contig extremity of each chain
    (cycling through them)."""
    import torch

    out = []
    for c in range(states.pos.shape[0]):
        ext = extremities(type(states)(*[x[c] for x in states]))
        out.append(int(ext[k % len(ext)]))
    return torch.tensor(out, device=states.pos.device)


def chains_inputs(states, nb, params_c, scorer, extract, gen):
    """B4's and B2's arguments of one chains-axis step at the scorer's
    bucket: each chain's fA a contig extremity, its neighbours drawn as the
    step draws them, its member rows extracted on their own; M = chains x
    slots, and B2's parameters one row per slot."""
    import torch
    from graal_tpu_torch.core import mcmc

    dev = states.pos.device
    n_chains = states.pos.shape[0]
    f_a = chain_extremities(states, 0)
    u = torch.rand((n_chains, nb.pk.shape[1]), generator=gen, device=dev)
    ids, _ = mcmc.sample_neighbours(u, f_a, states, nb, DELTA)
    rows, valid, _ = extract(states, f_a, ids, scorer.f_max)
    _, vec, ob, pvec = scorer.inputs(states, f_a, ids, rows, valid, params_c,
                                     states.id_c.amax(-1))
    b4 = (scorer.sobs.row_start, scorer.sobs.cols, scorer.sobs.vals, vec.keys)
    return b4, scorer.mini_grid_args(vec, ob, pvec), ids.shape[1]


def check_chains_kernels(label, scorer, b4, args, m_per_chain, abs_scores=True):
    """B4 bit-identical and B2 (an (M, 10) parameter matrix) within
    B2_ABS_ERR of their plain versions, scores and deltas (and, as
    everywhere, the scores within RTOL and the deltas within DLL_ATOL); a
    (10,) vector and the same vector broadcast to (M, 10) give the same
    bits; each chain's slots alone, with their own (10,) vector, give the
    bits of the batch. Both timed. Without ``abs_scores`` the scores are
    held to RTOL only: B2_ABS_ERR is a few ulps of the scores of the
    buckets up to 4,096, and at R = 16,384 the scores reach 2.6e4, whose
    ulp is 0.002. Returns (B2 record, B4 record)."""
    import torch

    m = args[0].shape[0]
    _, err4 = b4_vs_plain(scorer.obs_grid_kernel, b4, label)
    print_b4_plan(scorer.obs_grid_kernel, b4[3])
    s_k, err, dll_err, cls = b2_vs_plain(scorer.mini_grid, args, label)
    gated = max(err, dll_err) if abs_scores else dll_err
    print(f"  B2 {label}: scores max_abs_err {err:.6g}, dll max_abs_err {dll_err:.6g} "
          f"(gate {B2_ABS_ERR} on {'both' if abs_scores else 'the deltas'})")
    check(gated <= B2_ABS_ERR, f"{label}: B2 error {gated} > {B2_ABS_ERR}")
    one = args[6][0]
    shared = scorer.mini_grid.launch(*args[:6], one)
    rows = scorer.mini_grid.launch(*args[:6], one.expand(m, one.shape[0]).contiguous())
    check(all(torch.equal(a, b) for a, b in zip(shared, rows)),
          f"{label}: a (10,) vector and its (M, 10) broadcast differ")
    for c in range(m // m_per_chain):
        sl = slice(c * m_per_chain, (c + 1) * m_per_chain)
        alone = scorer.mini_grid.launch(*[x[sl].contiguous() for x in args[:6]],
                                        args[6][sl.start].contiguous())
        check(torch.equal(alone[0], s_k[sl]), f"{label}: chain {c} alone differs from the batch")
    print(f"  B2 {label}: (10,) == broadcast (M, 10) bit for bit; every chain's slots alone "
          "with their own (10,) vector equal the batch")
    r = args[0].shape[2]
    n_iter = min(100, max(5, 50 * 1024 * 1024 // (r * r)))
    n_plain = 2 if r < 8192 else 1
    t2 = with_share(timed(lambda: scorer.mini_grid.launch(*args), n_iter,
                          lambda: scorer.mini_grid.plain(*args), n_plain), mini_bound(args, cls))
    t2["classes"] = class_shares(cls)
    print(f"  time B2 R={r} M={m} (per-slot params): {fmt_time(t2)}; {fmt_bound(t2)}")
    plain4 = None if r * r * m * 4 > 4 * PLAIN_GRID_BYTES else \
        (lambda: scorer.obs_grid_kernel.plain(*b4))
    t4 = with_share(timed(lambda: scorer.obs_grid_kernel.launch(*b4), n_iter, plain4, n_plain),
                    obsgrid_bound(b4))
    print(f"  time B4 R={r} M={m}: {fmt_time(t4)}; {fmt_bound(t4)}")
    return dict(max_abs_err=err, dll_max_abs_err=dll_err, M=m, R=r, **t2), \
        dict(max_abs_err=err4, M=m, R=r, **t4)


def chains_equal_single(label, step, states, nb, params_c, n_steps, gen):
    """``n_steps`` chains-axis steps, each chain held to its single-chain
    step on the same draws: states and carried deltas bit for bit, and one
    B2 and one B4 launch a chains step."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.parallel.tempering import draw_chain_inputs

    n_chains = states.pos.shape[0]
    dev = states.pos.device
    ladder = torch.tensor([1.0, 1.5, 2.5, 4.0][:n_chains], device=dev)
    for it in range(n_steps):
        draws = draw_chain_inputs(gen, nb, DELTA, n_chains)
        f_a = chain_extremities(states, it)
        counts = step.counts()
        new, l_new, outs = step(states, draws, params_c, torch.zeros(n_chains, device=dev),
                                f_a, ladder)
        check(step.counts() == tuple(x + 1 for x in counts),
              f"{label}: a chains step launched {step.counts()} (from {counts}), not one each")
        for c in range(n_chains):
            one = step(type(states)(*[x[c] for x in states]),
                       mcmc.StepDraws(draws.u_nb[c], draws.gumbel[c], None, None, None),
                       type(params_c)(*[x[c] for x in params_c]),
                       torch.zeros((), device=dev), f_a[c], float(ladder[c]))
            check(all(torch.equal(a[c], b) for a, b in zip(new, one[0])) and
                  torch.equal(l_new[c], one[1]) and
                  all(torch.equal(a[c], b) for a, b in zip(outs, one[2])),
                  f"{label}: step {it}, chain {c} differs from its single-chain step")
        states = new
    print(f"  {label}: {n_steps} chains steps, each chain bit-identical to its single-chain "
          f"step on the same draws (states, deltas, ops); one B2 and one B4 launch a step")
    return states


def counting_step(runner, table, sobs, nb, f_max, rep=None):
    """The runner's delta step at ``f_max`` (launching through its
    wrappers), with ``counts()`` = (ll_mini, obsgrid) launches so far."""
    from graal_tpu_torch.core import delta

    step = delta.make_delta_em_step(table, None, nb, DELTA, f_max, sobs=sobs, band_w=runner.w,
                                    obs_grid=runner.obs_grid, mini_grid=runner.mini_grid,
                                    rep=rep)
    step.counts = lambda: (runner.mini_grid.n_launches, runner.obs_grid.n_launches)
    return step


def chains_main(label, runner, state0, n_chains, steps, f_max_min, drift_bound,
                must_rise=True):
    """``ScaleRunner.run_chains`` for one cycle of ``steps`` steps a chain
    (nuisance on, one swap round): launches one B2 and one B4 a step for
    all chains (counts set to 0 just before, read just after), each
    chain's carried likelihood within ``drift_bound`` of its re-anchor,
    every chain's genome valid, the best likelihood above the start's
    (with ``must_rise``; a start at the truth need not rise)."""
    import torch
    from graal_tpu_torch.core.mcmc import n_slots
    from graal_tpu_torch.core.state import check_invariants

    l0 = runner.anchor_fn()(state0, runner.params).item()
    torch.cuda.synchronize()
    runner.mini_grid.n_launches = runner.obs_grid.n_launches = 0
    corr_wrapper().n_launches = rows_wrapper().n_launches = inputs_wrapper().n_launches = 0
    t0 = time.perf_counter()
    final, best, m = runner.run_chains(state0, n_chains=n_chains, n_cycles=1,
                                       steps_per_cycle=steps, f_max_min=f_max_min, t_max=4.0,
                                       exchange_every=1, sample_param=True, seed=SEED + 11,
                                       chunk_steps=steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (runner.mini_grid.n_launches, runner.obs_grid.n_launches)
    floor, rel = drift_bound
    lls = m["likelihood"][-1]
    drift = m["drift"][-1]
    bad = sum(d > max(floor, rel * abs(x)) for d, x in zip(drift, lls))
    slots = n_slots(runner.nb, DELTA) // 13
    print(f"  {label}: {n_chains} chains x {steps} steps at f_max {m['f_max']} (M = "
          f"{n_chains} x {slots}), launches ll_mini {launches[0]}, obsgrid {launches[1]} "
          f"(one of each a step: {steps}); likelihood {l0:.3f} -> chains {lls}, best "
          f"{best:.3f}; swaps {m['swaps']}; drift per chain {drift} (bound max({floor}, "
          f"{rel} |L|)); {seconds:.2f} s, cycle {m['cycle_s'][-1]:.3f} s "
          f"({m['cycle_s'][-1] * 1e3 / steps:.3f} ms/step for all chains)")
    check(launches == (steps, steps), f"{label}: launches {launches} != one each a step")
    # every chain's rows in one G1 + G2 pair and one G3 a step
    want_rows_launches("_".join(label.replace("(", "").replace(")", "").split()), rows_launches(),
                       steps)
    if runner.table.has_repeats:      # every chain's corrections in one pair a step
        want_corr_launches("run_chains_repeat_20k", corr_launches(), steps)
    else:
        check(corr_launches() == {}, f"{label}: a repeat-free path launched F1 / F2")
    check(bad == 0, f"{label}: {bad} chains' carried likelihood drifted beyond the bound")
    check(best > l0 or not must_rise, f"{label}: best likelihood {best} did not rise above {l0}")
    for c in range(n_chains):
        st = type(final)(*[x[c] for x in runner.chain_states])
        check(check_invariants(st, raise_on_error=False) == [], f"{label}: chain {c} invariants")
    rescored = runner.anchor_fn()(final, m["params"]).item()
    check(abs(rescored - best) <= max(0.5, 1e-6 * abs(best)),
          f"{label}: the best chain's params score its genome to {rescored}, not {best}")
    return dict(launches=launches, steps=steps, f_max=m["f_max"][-1], drift=drift,
                likelihood=lls, best=best, l0=l0, seconds=seconds, cycle_s=m["cycle_s"][-1],
                swaps=m["swaps"], bad_steps=bad)


def phase_chains(sc):
    """11a. Tempered chains on the 100k problem (ScaleRunner.run_chains)."""
    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.scale import ScaleRunner

    print(f"run_chains at {sc['n']} fragments: {CHAINS} chains, f_max_min {F_MAX}, delta "
          f"{DELTA}, per-chain params")
    runner = ScaleRunner(sc["table"], sc["sobs"], sc["params"], nb=sc["runner"].nb)
    states = chain_starts(sc)
    pc = chain_params(sc["params"])
    gen = torch.Generator(device=states.pos.device).manual_seed(SEED)
    scorer = delta.make_delta_scorer(sc["table"], None, F_MAX, sobs=sc["sobs"],
                                     obs_grid=runner.obs_grid, mini_grid=runner.mini_grid)
    b4, args, m = chains_inputs(states, runner.nb, pc, scorer, delta.extract_rows_union, gen)
    check(args[0].shape[0] == CHAINS * m == 20 and args[6].shape == (20, 10),
          f"chains step inputs: M {args[0].shape[0]}, pvec {tuple(args[6].shape)}")
    b2_rec, b4_rec = check_chains_kernels(f"{CHAINS} chains R={F_MAX}", scorer, b4, args, m)
    step = counting_step(runner, sc["table"], sc["sobs"], runner.nb, F_MAX)
    chains_equal_single(f"{CHAINS} chains at f_max {F_MAX}", step, states, runner.nb, pc,
                        CHAIN_EQ_STEPS, gen)
    # the chains' chunk alone under sync debug "error": no host read inside
    cycle = runner.chains_cycle_for(F_MAX, DELTA)
    order = torch.stack([torch.randperm(sc["n"], generator=gen, device=states.pos.device)
                         [:CHAIN_CHUNK] for _ in range(CHAINS)])
    l0 = runner.chains_anchor_fn()(states, pc)
    ladder = torch.tensor([1.0, 1.5, 2.5, 4.0], device=states.pos.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cur, l_t, _ = cycle(states, gen, pc, order, l0, ladder)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    l_re = runner.chains_anchor_fn()(cur, pc)
    drift = (l_t - l_re).abs().tolist()
    print(f"  a {CHAIN_CHUNK}-step chunk of all chains under sync debug mode \"error\": carried "
          f"{l_t.tolist()}, re-anchored {l_re.tolist()}, drift {drift}")
    check(all(d <= max(0.5, 1e-6 * abs(x)) for d, x in zip(drift, l_re.tolist())),
          f"chains chunk drift {drift}")
    out = chains_main("run_chains (main path)", runner, sc["shuf"], CHAINS, CHAIN_STEPS, F_MAX,
                      (0.5, 1e-6))
    bucket = out["f_max"]
    if bucket != F_MAX:   # the kernels at the bucket the run used, too
        sc_b = delta.make_delta_scorer(sc["table"], None, bucket, sobs=sc["sobs"],
                                       obs_grid=runner.obs_grid, mini_grid=runner.mini_grid)
        b4_b, args_b, m = chains_inputs(states, runner.nb, pc, sc_b, delta.extract_rows_union,
                                        gen)
        b2_b, b4_bb = check_chains_kernels(f"{CHAINS} chains R={bucket}", sc_b, b4_b, args_b, m)
        out.update(b2_bucket=b2_b, b4_bucket=b4_bb)
    return dict(out, ll_mini=b2_rec, obsgrid=b4_rec)


def phase_chains_top(sc):
    """11e. run_chains at the top buckets: 4 chains from the truth cut into
    40 pieces (bucket 8,192, M = 20) for TOP_CHAIN_STEPS steps and from the
    truth (bucket 16,384, M = 20) for TOP16_CHAIN_STEPS, no call of the
    banded mass, with chains_main's checks and the peak memory of each;
    then B4 and B2 against their plain versions on a chains step's inputs
    at each bucket (check_chains_kernels)."""
    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.scale import ScaleRunner

    runner = ScaleRunner(sc["table"], sc["sobs"], sc["params"], nb=sc["runner"].nb)
    pc = chain_params(sc["params"])
    gen = torch.Generator(device=sc["truth"].pos.device).manual_seed(SEED)
    out = {}
    for start, steps, bucket in ((sc["halves"], TOP_CHAIN_STEPS, TOP_TIERS[0]),
                                 (sc["truth"], TOP16_CHAIN_STEPS, TOP_TIERS[1])):
        print(f"run_chains at {sc['n']} fragments from {int(start.n_contigs())} contigs: "
              f"{CHAINS} chains x {steps} steps")
        peak = PeakMemory()
        with banded_calls() as banded:
            rec = chains_main(f"run_chains at bucket {bucket}", runner, start, CHAINS, steps,
                              F_MAX, (0.5, 1e-6), must_rise=False)
        rec["peak_gb"] = peak.read(f"run_chains, {CHAINS} chains at bucket {bucket}")[0]
        check(rec["f_max"] == bucket, f"run_chains ran at bucket {rec['f_max']}, not {bucket}")
        check(banded[0] == 0, f"run_chains at bucket {bucket}: {banded[0]} banded mass calls")
        rec["banded_calls"] = banded[0]
        states = GenomeState(*[x.expand(CHAINS, -1).contiguous() for x in start])
        scorer = delta.make_delta_scorer(sc["table"], None, bucket, sobs=sc["sobs"],
                                         obs_grid=runner.obs_grid, mini_grid=runner.mini_grid)
        b4, args, m = chains_inputs(states, runner.nb, pc, scorer, delta.extract_rows_union,
                                    gen)
        peak = PeakMemory()
        rec["ll_mini"], rec["obsgrid"] = check_chains_kernels(
            f"{CHAINS} chains R={bucket}", scorer, b4, args, m, abs_scores=False)
        rec["ll_mini"]["peak_gb"] = peak.read(f"B2 / B4 checks at M = {args[0].shape[0]}, "
                                              f"R = {bucket}")[0]
        out[bucket] = rec
        del b4, args, states, scorer
    return out


def phase_chains_repeats(rsc, n_chains=3, steps=128):
    """11b. The 20k repeat twin under run_chains."""
    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.scale import ScaleRunner

    print(f"run_chains on the repeat twin ({rsc['n']} fragments): {n_chains} chains")
    runner = ScaleRunner(rsc["table"], rsc["sobs"], rsc["params"], nb=rsc["runner"].nb,
                         **rsc["runner_kw"])
    states = chain_starts(rsc, n_chains)
    pc = chain_params(rsc["params"], n_chains)
    anchor = runner.chains_anchor_fn()
    step = counting_step(runner, rsc["table"], rsc["sobs"], runner.nb, F_MAX,
                         rep=rsc["shuf"].rep)
    gen = torch.Generator(device=states.pos.device).manual_seed(SEED)
    states = chains_equal_single(f"repeat twin, {n_chains} chains", step, states, runner.nb, pc,
                                 CHAIN_EQ_STEPS, gen)
    # per-step exactness of every chain: each chains step re-anchored
    bad, worst, moved = 0, 0.0, 0
    l_t = anchor(states, pc)
    ladder = torch.ones(n_chains, device=states.pos.device)
    from graal_tpu_torch.parallel.tempering import draw_chain_inputs

    for it in range(10):
        f_a = chain_extremities(states, it + CHAIN_EQ_STEPS)
        new, l_new, outs = step(states, draw_chain_inputs(gen, runner.nb, DELTA, n_chains), pc,
                                l_t, f_a, ladder)
        l_re = anchor(new, pc)
        for c in range(n_chains):
            err = abs(l_new[c].item() - l_re[c].item())
            worst = max(worst, err)
            bad += err > max(0.5, 1e-6 * abs(l_re[c].item()))
            moved += int(outs[0][c]) >= 0
        states, l_t = new, l_re
    print(f"  per-step exactness: {10 * n_chains} chain steps, {moved} moves, bad_steps {bad}, "
          f"worst {worst:.6g}")
    check(bad == 0, f"repeat chains: {bad} steps beyond max(0.5, 1e-6 |L|)")
    out = chains_main("run_chains (repeat twin)", runner, rsc["shuf"], n_chains, steps, F_MAX,
                      rsc["drift_bound"])
    # B2 / B4 at the run's bucket on the chains' inputs (the single-copy part)
    from graal_tpu_torch.core.delta_repeats import make_repeat_delta_scorer_v2

    engine = make_repeat_delta_scorer_v2(rsc["table"], out["f_max"], rsc["sobs"],
                                         rsc["shuf"].rep, obs_grid=runner.obs_grid,
                                         mini_grid=runner.mini_grid)
    b4, args, m = chains_inputs(states, runner.nb, pc, engine.plain, delta.extract_rows_each,
                                gen)
    b2_rec, b4_rec = check_chains_kernels(f"repeat twin, {n_chains} chains R={out['f_max']}",
                                          engine.plain, b4, args, m)
    return dict(out, exact_bad_steps=bad, exact_worst=worst, ll_mini=b2_rec, obsgrid=b4_rec)


def phase_cli_scale_chains(ds, root):
    """11c. scale --chains 4 --t-max 4 at level 1, then --resume, then
    --snapshot-every 1 --watch --profile; and run --snapshots --watch
    --profile at level 2 of a small dataset."""
    import importlib.util

    import numpy as np
    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.core.state import check_invariants

    has_mpl = importlib.util.find_spec("matplotlib") is not None

    def argv(out, cycles, *extra, steps=CLI_CHAIN_STEPS):
        return ["scale", ds, "--size", "3", "--level", "1", "--cycles", str(cycles),
                "--chains", str(CHAINS), "--t-max", "4", "--steps-per-cycle", str(steps),
                "--f-max-min", "64", "--fasta", os.path.join(ds, "genome.fa"), "--out", out,
                *extra]

    print(f"cli scale --chains {CHAINS} --t-max 4: level 1, {CLI_CHAIN_STEPS} steps a chain "
          "a cycle, f_max_min 64")
    full, part = os.path.join(root, "o11c"), os.path.join(root, "o11c_resumed")
    t0 = time.perf_counter()
    runner, final, m = cli(argv(full, 2))
    seconds = time.perf_counter() - t0
    ch = m["chains"]
    launches = (runner.mini_grid.n_launches, runner.obs_grid.n_launches)
    print(f"  launches ll_mini {launches[0]}, obsgrid {launches[1]} (one of each a step: "
          f"{2 * CLI_CHAIN_STEPS}); best {ch['best']}, f_max {ch['f_max']}, swaps {ch['swaps']}, "
          f"drift {ch['drift']}; {seconds:.1f} s, cycles {ch['cycle_s']} s")
    check(launches == (2 * CLI_CHAIN_STEPS,) * 2, f"cli scale --chains launches {launches}")
    check(check_invariants(final, raise_on_error=False) == [], "cli scale --chains invariants")
    # the run's B2 / B4 at its bucket on one chains step of its final chains
    bucket = ch["f_max"][-1]
    scorer = delta.make_delta_scorer(runner.table, None, bucket, sobs=runner.sobs,
                                     band_w=delta.effective_band_w(runner.w, runner.table,
                                                                   bucket),
                                     obs_grid=runner.obs_grid, mini_grid=runner.mini_grid)
    check(scorer.band_w is None, "the chains run's bucket takes the banded path, not B2")
    gen = torch.Generator(device=final.pos.device).manual_seed(SEED)
    b4, args, m_slots = chains_inputs(runner.chain_states, runner.nb,
                                      chain_params(runner.params), scorer,
                                      delta.extract_rows_union, gen)
    b2_rec, b4_rec = check_chains_kernels(f"cli scale --chains R={args[0].shape[2]}", scorer,
                                          b4, args, m_slots)
    check_outputs(full, ["0list_likelihood.txt", "0list_n_contigs.txt", "0list_f_max.txt",
                         "0list_d_nuc.txt", "genome.fasta", "info_frags.txt",
                         "chains_checkpoint.npz"])
    cli(argv(part, 1))
    _, res, _ = cli(argv(part, 2, "--resume"))
    check(all(torch.equal(a, b) for a, b in zip(final, res)),
          "scale --chains --resume: the final genome differs from the uninterrupted run")
    with open(os.path.join(full, "genome.fasta")) as fa, \
            open(os.path.join(part, "genome.fasta")) as fb:
        check(fa.read() == fb.read(), "scale --chains --resume: genome.fasta differs")
    with np.load(os.path.join(full, "chains_checkpoint.npz")) as a, \
            np.load(os.path.join(part, "chains_checkpoint.npz")) as b:
        diff = [k for k in a.files if k != "m_cycle_s" and not np.array_equal(a[k], b[k])]
    check(not diff, f"scale --chains --resume: checkpoint entries differ: {diff}")
    print("  --resume (1 cycle, then 2 resumed): final genome, genome.fasta and every "
          "checkpoint entry but the wall times equal the uninterrupted run")
    watch = os.path.join(root, "o11c_watch")
    t0 = time.perf_counter()
    # the traced cycle (one chain's run) takes --steps-per-cycle steps too
    cli(argv(watch, 1, "--snapshot-every", "1", "--watch", "--profile", steps=CLI_WATCH_STEPS))
    watch_s = time.perf_counter() - t0
    check_outputs(watch, ["live.html", "live_status.json", "live_particles.json",
                          "profile/trace.json"] +
                  (["layout_0001.png", "layout_latest.png", "genome_layout.png"]
                   if has_mpl else []))
    with open(os.path.join(watch, "profile", "trace.json")) as fh:
        trace = fh.read()
    check("ll_mini_items" in trace and "obsgrid_rows" in trace,
          "the scale profile trace does not name the B2 / B4 kernels")
    status = json.load(open(os.path.join(watch, "live_status.json")))
    print(f"  --snapshot-every 1 --watch --profile: live page and JSON written (stats "
          f"{status['stats']}), trace names ll_mini_items and obsgrid_rows; matplotlib "
          f"{'present: paintings written' if has_mpl else 'absent: no .png asked for'}; "
          f"{watch_s:.1f} s")
    # run --snapshots --watch --profile on B1 (the trace is the second
    # cycle's), on a small dataset: a traced cycle costs several untraced ones
    small = os.path.join(root, "ds_small")
    cli(["simulate", small, "--bins", str(SMALL_BINS), "--contigs", "4", "--seed", str(SEED)])
    cli(["pyramid", small, "--size", "3"])
    runo = os.path.join(root, "o11c_run")
    t0 = time.perf_counter()
    runner_r, asm = cli(run_argv(small, runo, "--cycles", "2", "--snapshots", "--watch",
                                 "--profile", "--snapshot-every", "1"))
    run_s = time.perf_counter() - t0
    check_outputs(runo, ["pre_assembly.npy", "post_assembly.npy", "snapshot_0001.npy",
                         "snapshot_0002.npy", "live.html", "live_status.json",
                         "live_particles.json", "profile/trace.json"] +
                  (["genome_layout.png", "layout_latest.png"] if has_mpl else []))
    with open(os.path.join(runo, "profile", "trace.json")) as fh:
        check("ll_dense_items" in fh.read(), "the run profile trace does not name ll_dense")
    snap = np.load(os.path.join(runo, "snapshot_0002.npy"))
    check(snap.shape[0] == snap.shape[1] > 0, f"snapshot shape {snap.shape}")
    print(f"  run --snapshots --watch --profile --snapshot-every 1: snapshots {snap.shape}, "
          f"live files, trace names ll_dense_items; {run_s:.1f} s")
    return dict(launches=launches, ll_mini=b2_rec, obsgrid=b4_rec, seconds=seconds,
                cycle_s=ch["cycle_s"],
                best=ch["best"], swaps=ch["swaps"], drift=ch["drift"], watch_s=watch_s,
                run_s=run_s, run_launches=runner_r.scorer.n_launches)


def dist_checks(device, world):
    """Each sharded function of ``parallel.sharding`` against the
    one-process result on this rank: the dense likelihood (rows split
    over the world), the sparse anchor (4 chains with their own params)
    and a delta cycle of 4 chains split over the world (rows = 1). Returns
    the numbers and the bit-equality flags."""
    import torch
    from graal_tpu_torch.core import delta, sparse
    from graal_tpu_torch.entry import problem, scale_problem
    from graal_tpu_torch.parallel import sharding
    from graal_tpu_torch.scale import ScaleRunner

    state, table, params, obs, _ = problem(device=device)
    got = sharding.sharded_log_likelihood(sharding.make_mesh(1, world), table,
                                          obs)(state, params)
    one = sharding._block_log_likelihood(state, table, torch.as_tensor(obs, device=device),
                                         params, 0).float()
    truth, shuf, stable, sparams, sobs = scale_problem(EXACT_BINS, device=device)
    runner = ScaleRunner(stable, sobs, sparams)
    sc = dict(truth=truth, shuf=shuf)
    states = chain_starts(sc)
    pc = chain_params(sparams)
    anchor = sharding.make_sharded_sparse_anchor(sharding.make_mesh(1, world),
                                                 stable, sobs, runner.w)(states, pc)
    anchor_one = sparse.make_sparse_loglik(stable, sobs, runner.w)(states, pc)
    orders = torch.stack([torch.randperm(EXACT_BINS, generator=torch.Generator(device=device)
                                         .manual_seed(c), device=device)[:DIST_STEPS]
                          for c in range(CHAINS)])
    ladder = torch.tensor([1.0, 1.5, 2.5, 4.0], device=device)
    cyc = sharding.make_sharded_delta_cycle(sharding.make_mesh(world, 1), stable,
                                            runner.nb, DELTA, F_MAX, sobs=sobs, band_w=runner.w,
                                            per_chain_params=True)
    got_c = cyc(states, torch.Generator(device=device).manual_seed(3), pc, orders, anchor_one,
                ladder)
    one_c = delta.make_delta_em_cycle(stable, None, runner.nb, DELTA, F_MAX, sobs=sobs,
                                      anchor_fn=False, band_w=runner.w)(
        states, torch.Generator(device=device).manual_seed(3), pc, orders, anchor_one, ladder)
    torch.cuda.synchronize()
    return dict(
        ll=got.item(), ll_one=one.item(), ll_equal=bool(torch.equal(got, one)),
        anchor=anchor.tolist(), anchor_one=anchor_one.tolist(),
        anchor_equal=bool(torch.equal(anchor, anchor_one)),
        cycle_equal=all(torch.equal(a, b) for a, b in zip(got_c[0], one_c[0]))
        and bool(torch.equal(got_c[1], one_c[1])),
        cycle_moved=bool((got_c[0].id_c != states.id_c).any()), l_ts=got_c[1].tolist())


def dist_child(rank, world, store, out, backend):
    """One rank of phase 11d's worlds (``python3 chip_smoke.py --dist-child
    ...``): joins the world, runs :func:`dist_checks` on its card, writes
    the results."""
    import torch
    import torch.distributed as dist

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        res = dist_checks(device, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


def dist_world(root, world, backend):
    """Launch a ``world``-process ``backend`` world of this script's
    :func:`dist_child`, each process with a timeout; returns every rank's
    results."""
    d = os.path.join(root, f"{backend}{world}")
    os.makedirs(d)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-child",
                               str(r), str(world), os.path.join(d, "store"), d, backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise SmokeFailure(f"the {world}-rank {backend} world did not finish in "
                           f"{DIST_TIMEOUT_S} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{backend} rank {r} failed:\n{out[-3000:]}")
    res = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(world)]
    return res, time.perf_counter() - t0


def phase_dist(device):
    """11d. parallel.sharding on the card: a 1-rank NCCL world in this
    process, a 2-rank gloo world with both ranks on cuda:0, and NCCL
    across the cards when there are several."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    out = {}
    with tempfile.TemporaryDirectory(prefix="graal_dist_") as root:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{root}/store1", rank=0,
                                world_size=1)
        try:
            r1 = dist_checks(device, 1)
        finally:
            dist.destroy_process_group()
        out["nccl1"] = dict(r1, seconds=time.perf_counter() - t0)
        print(f"1-rank NCCL world (FileStore): dense ll {r1['ll']} (one process "
              f"{r1['ll_one']}), anchor {r1['anchor']}, cycle l_ts {r1['l_ts']}; "
              f"{out['nccl1']['seconds']:.1f} s")
        check(r1["ll_equal"] and r1["anchor_equal"] and r1["cycle_equal"],
              "the 1-rank NCCL world differs from the one-process results")
        check(r1["cycle_moved"], "the sharded delta cycle moved nothing")
        worlds = [(2, "gloo")] + ([(torch.cuda.device_count(), "nccl")]
                                  if torch.cuda.device_count() > 1 else [])
        for world, backend in worlds:
            out[f"{backend}{world}"] = checked_world(root, world, backend)
    return out


def checked_world(root, world, backend):
    """A ``world``-rank ``backend`` world of :func:`dist_child`, held to the
    one-process results: likelihood and anchor within rtol 1e-5 / 1e-6,
    the chains split over the ranks bit for bit, every rank alike."""
    import numpy as np

    res, seconds = dist_world(root, world, backend)
    for r, x in enumerate(res):
        check(np.allclose(x["ll"], x["ll_one"], rtol=1e-5, atol=0.0),
              f"{backend} rank {r}: sharded ll {x['ll']} vs one process {x['ll_one']}")
        check(np.allclose(x["anchor"], x["anchor_one"], rtol=1e-6, atol=0.0),
              f"{backend} rank {r}: sharded anchor {x['anchor']} vs {x['anchor_one']}")
        check(x["cycle_equal"], f"{backend} rank {r}: the chains split over the ranks "
              "differ from the one-process chains")
        check(x == res[0], f"{backend} rank {r}'s results differ from rank 0's")
    where = "both on cuda:0" if backend == "gloo" else "one card a rank"
    print(f"{world}-rank {backend} world ({where}): dense ll {res[0]['ll']} (one process "
          f"{res[0]['ll_one']}), anchor {res[0]['anchor']} (one process "
          f"{res[0]['anchor_one']}), chains over ranks == one process bit for bit; "
          f"{seconds:.1f} s")
    return dict(res[0], seconds=seconds)


def phase_cards(device):
    """``python3 chip_smoke.py --cards``, on a host with several cards:
    parallel.sharding in an NCCL world of one rank a card (as 11d), and the
    CLI under ``torchrun`` across the cards (``scale --chains 4 --t-max 4``
    at level 1, 2 cycles of 256 steps, and ``run --sampler tempered
    --chains 4`` at level 2) against the same commands in one process on
    one card: the likelihood series and genome.fasta must be the same."""
    import tempfile

    import torch

    n = torch.cuda.device_count()
    check(n > 1, f"--cards needs several cards, this host has {n}")
    out = {}
    with tempfile.TemporaryDirectory(prefix="graal_cards_") as root:
        out[f"nccl{n}"] = checked_world(root, n, "nccl")
        ds = phase_dataset(root)
        fa = os.path.join(ds, "genome.fa")
        runs = {"scale_chains": ["scale", ds, "--size", "3", "--level", "1", "--cycles", "2",
                                 "--chains", str(CHAINS), "--t-max", "4", "--steps-per-cycle",
                                 str(CLI_CHAIN_STEPS), "--f-max-min", "64", "--fasta", fa],
                "run_tempered": ["run", ds, "--size", "3", "--level", "2", "--fasta", fa,
                                 "--cycles", "1", "--sampler", "tempered", "--chains",
                                 str(CHAINS)]}
        launchers = {"torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                  f"--nproc-per-node={n}", "-m", "graal_tpu_torch.cli"],
                     "one_process": [sys.executable, "-m", "graal_tpu_torch.cli"]}
        for name, args in runs.items():
            rec = {}
            for how, cmd in launchers.items():
                o = os.path.join(root, f"{name}_{how}")
                t0 = time.perf_counter()
                r = subprocess.run(cmd + args + ["--out", o], capture_output=True, text=True,
                                   timeout=DIST_TIMEOUT_S)
                check(r.returncode == 0, f"{name} ({how}) failed:\n{r.stdout[-3000:]}"
                      f"\n{r.stderr[-3000:]}")
                with open(os.path.join(o, "0list_likelihood.txt")) as fh, \
                        open(os.path.join(o, "genome.fasta")) as fg:
                    rec[how] = dict(seconds=time.perf_counter() - t0, likelihood=fh.read(),
                                    fasta=fg.read())
            same = rec["torchrun"]["likelihood"] == rec["one_process"]["likelihood"] and \
                rec["torchrun"]["fasta"] == rec["one_process"]["fasta"]
            print(f"{name}: torchrun over {n} cards {rec['torchrun']['seconds']:.1f} s, one "
                  f"process on one card {rec['one_process']['seconds']:.1f} s; likelihood "
                  f"series and genome.fasta the same: {same}")
            check(same, f"{name}: torchrun across the cards differs from one process")
            out[name] = {h: dict(seconds=v["seconds"], likelihood=v["likelihood"].split())
                         for h, v in rec.items()}
    return out


def event_timed(fn, sync_error=False):
    """(fn(), ms) with the time between CUDA events around the call: the
    card's clock from the first enqueue to the last kernel's end.
    ``sync_error``: the call runs under sync debug mode "error", so that
    any host read of a device value inside it raises."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def trees_equal(a, b):
    """Nested tuples of tensors equal leaf by leaf, bit for bit."""
    import torch

    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(trees_equal(x, y) for x, y in zip(a, b)))
    return isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype \
        and torch.equal(a, b)


def graph_vs_eager(label, build, chunks, kernels, sync_error=False):
    """One path run twice on the same inputs: its cycle built with
    ``capture=True`` (the captured graph, the default on the card) and with
    ``capture=False`` (the same step body run eagerly). ``chunks``: the
    calls of a run, each ``call(cycle, carry) -> (carry, outputs)`` with the
    steps it runs; ``carry`` threads from one call to the next. Both runs
    must give the same states, likelihoods, parameters and per-step metrics
    bit for bit, and the same launches of every wrapper in ``kernels``, in
    all and by launch key (B1 / B3 by (B, K)), read from the card (counts
    set to 0 just before each run). ``sync_error``: each run's first call
    (the graph's holds its eager first step, its capture and replays) runs
    under sync debug mode "error". Prints and returns each run's ms per
    step (CUDA events around each call; the graph's first call includes its
    eager first step and capture) and peak memory (allocated, and reserved
    with the graphs' pool)."""
    import torch

    rec = {}
    outs = {}
    for mode, capture in (("graph", True), ("eager", False)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels + [vectors_wrapper(), scan_wrapper(), inputs_wrapper()]:
            k.n_launches = 0
        cycle = build(capture)
        carry, got, ms = None, [], []
        for i, (call, steps) in enumerate(chunks):
            (carry, out), t = event_timed(lambda: call(cycle, carry), sync_error and i == 0)
            got.append(out)
            ms.append(t / steps)
        outs[mode] = tuple(got)
        rec[mode] = dict(ms_per_step=ms, launches=[k.n_launches for k in kernels],
                         by_key=[{str(key): v for key, v in k.launches.by_key().items()}
                                 for k in kernels],
                         io=io_launches(), inputs=dict(inputs_wrapper().launches.by_key()),
                         peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                         peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
        del cycle, carry, got
    g, e = rec["graph"], rec["eager"]
    print(f"  {label}: steps {[n for _, n in chunks]}; ms/step graph {g['ms_per_step']}, "
          f"eager {e['ms_per_step']}; launches graph {g['launches']}, eager {e['launches']}; "
          f"peak GB allocated / reserved graph {g['peak_allocated_gb']:.3f} / "
          f"{g['peak_reserved_gb']:.3f}, eager {e['peak_allocated_gb']:.3f} / "
          f"{e['peak_reserved_gb']:.3f}")
    check(trees_equal(outs["graph"], outs["eager"]),
          f"{label}: the graphed run differs from the eager run")
    check(g["launches"] == e["launches"] and g["by_key"] == e["by_key"],
          f"{label}: launches {g['by_key']} (graph) != {e['by_key']} (eager)")
    check(g["io"] == e["io"], f"{label}: H1-H3 launches {g['io']} (graph) != {e['io']} (eager)")
    check(g["inputs"] == e["inputs"],
          f"{label}: I1 / I2 launches {g['inputs']} (graph) != {e['inputs']} (eager)")
    check(all(x > 0 for x in g["launches"]), f"{label}: a kernel of the path never launched")
    print("    graph == eager bit for bit: states, likelihoods, parameters, metrics"
          + (f"; launches by key {g['by_key']}" if kernels else "") + f"; H1-H3 {g['io']}"
          + (f"; I1 / I2 {g['inputs']}" if g["inputs"] else "")
          + ("; each run's first call under sync debug mode \"error\"" if sync_error else ""))
    return rec


def dense_graph_case(device, n_bins=384):
    """The dense flagship (B1): 2 EM cycles from the exploded start,
    nuisance sampling on, the second at another f_t and with the first
    cycle's parameters perturbed (fact x 1.02)."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    state, table, params, obs, nb = problem(n_bins=n_bins, device=device)
    scorer = make_dense_scorer(table, obs, device)
    n = state.n_frags
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    start = mcmc.explode_genome(state)
    l0 = scorer(GenomeState(*[x[None] for x in start]), params)[0]
    chunks = []
    for k, f_t in enumerate((1.0, 0.8)):
        order = torch.randperm(n, generator=gen, device=device)
        draws = mcmc.draw_step_inputs(gen, nb, DELTA, (n,))

        def call(cycle, carry, order=order, draws=draws, f_t=f_t, k=k):
            cur, par, l_t = carry or (start, params, l0)
            if k:
                par = par._replace(fact=par.fact * 1.02)
            cur, par, l_t, m = cycle(cur, draws, par, order, l_t, f_t)
            return (cur, par, l_t), (cur, par, l_t, m)

        chunks.append((call, n))

    def build(capture):
        return mcmc.make_em_cycle(table, obs, nb, DELTA, sample_param=True, scorer=scorer,
                                  capture=capture)

    return build, chunks, [scorer, step_wrapper(), catalogue_wrapper()]


def delta_graph_case(sc, chains=0, f_max=F_MAX, steps=(MAIN_STEPS, 128), start=None):
    """A delta path on B4 + B2 (as ScaleRunner.cycle_for / chains_cycle_for
    build it): chunks of ``steps`` steps from the set-up's shuffled start
    (or ``start``), the second at a lower f_t and with the parameters
    perturbed (fact x 1.02), as a runner's nuisance step between cycles
    would leave them. ``chains``: that many chains on a chains axis, each
    with its own parameters and temperature."""
    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.core.mcmc import draw_step_inputs
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.ops.mini_grid_cuda import MiniGridScorer
    from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid

    runner = sc["runner"]
    start = sc["shuf"] if start is None else start
    device = start.pos.device
    rep = start.rep
    grid, mini = WindowObsGrid(), MiniGridScorer()
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    if chains:
        states = (chain_starts(sc, chains) if start is sc["shuf"] else
                  GenomeState(*[x.expand(chains, -1).contiguous() for x in start]))
        params = chain_params(sc["params"], chains)
        l0 = runner.chains_anchor_fn()(states, params)
        temps = [torch.linspace(1.0, 4.0, chains, device=device),
                 torch.linspace(0.8, 3.2, chains, device=device)]
    else:
        states, params = start, sc["params"]
        l0 = runner.anchor_fn()(states, params)
        temps = [1.0, 0.8]
    lead = (chains,) if chains else ()
    chunks = []
    for k, (n_steps, f_t) in enumerate(zip(steps, temps)):
        order = torch.stack([torch.randperm(sc["n"], generator=gen, device=device)[:n_steps]
                             for _ in range(max(chains, 1))])
        order = order if chains else order[0]
        draws = draw_step_inputs(gen, runner.nb, DELTA, (n_steps,) + lead)

        def call(cycle, carry, order=order, draws=draws, f_t=f_t, k=k):
            cur, l_t = carry or (states, l0)
            par = params._replace(fact=params.fact * 1.02) if k else params
            cur, l_t, outs = cycle(cur, draws, par, order, l_t, f_t)
            return (cur, l_t), (cur, l_t, outs)

        chunks.append((call, n_steps))

    def build(capture):
        return delta.make_delta_em_cycle(sc["table"], None, runner.nb, DELTA, f_max,
                                         sobs=sc["sobs"], anchor_fn=False, band_w=runner.w,
                                         obs_grid=grid, mini_grid=mini, rep=rep,
                                         capture=capture)

    return build, chunks, repeat_kernels(sc) + [rows_wrapper(), mini, grid, step_wrapper(),
                                                catalogue_wrapper()]


def catalogue_wrapper():
    """The catalogue kernels' wrapper (C1 and C2, launches keyed "em" / "mh")."""
    from graal_tpu_torch.ops.candidates_cuda import CATALOGUE

    return CATALOGUE


def repeat_kernels(sc):
    """The copy-correction wrapper (F1 / F2) on a repeat problem's paths,
    first in a graph case's kernels; none on a repeat-free one."""
    return [corr_wrapper()] if sc["table"].has_repeats else []


def corr_paths(records, want_calls):
    """Keep each graphed repeat path's F1 / F2 launches (the graph run's,
    equal to the eager run's) for the kernels line, each one pair a scoring
    call (``want_calls[name]``)."""
    for name, calls in want_calls.items():
        got = records[name]["graph"]["by_key"][0]
        check(got == {"frozen": calls, "sums": calls},
              f"{name}: F1 / F2 launches {got} != one pair a scoring call ({calls})")
        CORR_PATHS[f"graph_{name}"] = got


def catalogue_paths(records):
    """Keep each graphed path's C1 / C2 launches (the graph run's, equal to
    the eager run's) for the kernels line: the catalogue's are the counts
    keyed by its kinds ("em", "mh")."""
    for name, rec in records.items():
        for by_key in rec["graph"]["by_key"]:
            if by_key and set(by_key) <= {"em", "mh"}:
                CATALOGUE_PATHS[f"graph_{name}"] = by_key


def catalogue_vs_plain(label, state, fa, fb, max_id=None, kinds=("em", "mh"),
                       with_base=False):
    """Each catalogue kernel of ``kinds`` (C1 "em", C2 "mh") against its plain
    version on the same inputs: all 11 fields bit for bit. Returns the
    kernels' outputs by kind."""
    import torch
    from graal_tpu_torch.core.candidates import build_candidates_plain, mh_candidates_plain
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.ops.candidates_cuda import CATALOGUE

    plain = {"em": build_candidates_plain, "mh": mh_candidates_plain}
    out = {}
    for kind in kinds:
        got = GenomeState(*CATALOGUE(kind, state, fa, fb, max_id, with_base))
        CAT_CALLS[kind] = CAT_CALLS.get(kind, 0) + 1
        want = plain[kind](state, fa, fb, max_id, with_base)
        for name, g, w in zip(GenomeState._fields, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w),
                  f"{label}: the {kind} catalogue's {name} differs from its plain version")
        out[kind] = got
    return out


def catalogue_pairs(label, state, gen, n_pairs=CAT_PAIRS, max_id=None, with_base=False,
                    frags=None):
    """C1 and C2 against their plain versions on ``n_pairs`` random (f_a,
    f_b) pairs of ``state`` (fields (n,): one genome broadcast; (R, n):
    pair k on row k mod R, with ``max_id`` (R,) the rows' maxima), one
    pair in ten with f_a == f_b, ``frags`` (when given) the f_a of every
    other pair; in calls of at most CAT_CHUNK_CELLS genome cells, the
    maximum taken from the state (None), given as an integer and as a
    tensor of one value a genome in turn. Returns the pairs compared."""
    import torch
    from graal_tpu_torch.core.state import GenomeState

    n = state.n_frags
    dev = state.pos.device
    rows = 1 if state.pos.dim() == 1 else state.pos.shape[0]
    chunk = max(1, min(-(-n_pairs // 3), CAT_CHUNK_CELLS // n))
    for k0 in range(0, n_pairs, chunk):
        b = min(chunk, n_pairs - k0)
        fa = torch.randint(0, n, (b,), generator=gen, device=dev)
        fb = torch.randint(0, n, (b,), generator=gen, device=dev)
        if frags is not None:
            pick = torch.randint(0, frags.numel(), (b,), generator=gen, device=dev)
            fa[::2] = frags[pick][::2]
        fb[::10] = fa[::10]
        at = torch.arange(k0, k0 + b, device=dev) % rows
        sub = state if rows == 1 else GenomeState(*[x.index_select(0, at) for x in state])
        if isinstance(max_id, torch.Tensor):
            mx = max_id.index_select(0, at)
        elif rows == 1:
            mx = (None, int(state.id_c.amax()) + 3,
                  state.id_c.amax().expand(b).to(torch.int64).contiguous())[(k0 // chunk) % 3]
        else:
            mx = max_id
        catalogue_vs_plain(f"{label}, pairs {k0}-{k0 + b}", sub, fa.to(torch.int32)
                           if k0 // chunk % 2 else fa, fb, mx, with_base=with_base)
    return n_pairs


def mini_states(state, f_as, nb, gen, f_max):
    """The delta engine's mini-states of a step at ``f_max``: for each chain
    c (``state`` fields (C, n), ``f_as`` (C,)) the DELTA x copies
    neighbours of f_as[c] drawn as the step draws them, their member rows
    (extract_rows_each) and mini-states (gather_mini); returns (minis
    (M, f_max), lf_a (M,), lf_b (M,), max_id (M,): each chain's maximum)."""
    import torch
    from graal_tpu_torch.core import delta, mcmc
    from graal_tpu_torch.core.state import GenomeState

    c = state.pos.shape[0]
    ids = torch.stack([mcmc.sample_neighbours(gen, f_as[k], GenomeState(*[x[k] for x in state]),
                                              nb, DELTA)[0] for k in range(c)])
    rows, valid, _ = delta.extract_rows_each(state, f_as, ids, f_max)
    mini = delta.gather_mini(state, rows, valid)
    m = ids.shape[1]
    mini = GenomeState(*[x.reshape(c * m, f_max) for x in mini])
    lf_a = (rows == f_as[:, None, None]).int().argmax(-1).reshape(-1)
    lf_b = (rows == ids[..., None]).int().argmax(-1).reshape(-1)
    return mini, lf_a, lf_b, state.id_c.amax(-1).repeat_interleave(m)


def collision_mini(device):
    """ROADMAP section C's input: contig 3 = [f0, f1], contig 4 = [f2, f3],
    the mini-state of rows [0, 1] (fA = f1, fB = f0) and the genome's
    maximum 4."""
    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.core.state import GenomeState

    state = GenomeState.from_soa(dict(pos=[0, 1, 0, 1], id_c=[3, 3, 4, 4],
                                      start_bp=[0, 1000, 0, 1000], len_bp=[1000] * 4,
                                      circ=[0] * 4, l_cont=[2] * 4, l_cont_bp=[2000] * 4),
                                 device=device)
    rows, valid, _ = delta.extract_rows_each(state, torch.tensor(1, device=device),
                                             torch.tensor([0], device=device), 2)
    mini, = delta.drop_chain(delta.gather_mini(*delta.lift_chain(state, rows, valid)))
    return mini, torch.tensor([1], device=device), torch.tensor([0], device=device), \
        state.id_c.amax()


def graph_device_ms(fn, n_iter):
    """ms per call of fn() on the device: fn captured once in a CUDA graph
    and its replays timed as :func:`device_ms` times calls. A call of
    hundreds of small kernels cannot be timed on the device by queueing
    the calls themselves: the launch queue fills and the device waits for
    the host; a replay is one launch, and its kernels run as a graphed
    step runs them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    try:
        return device_ms(graph.replay, n_iter)
    finally:
        del graph


def catalogue_record(kind, state, fa, fb, max_id=None, with_base=False):
    """C1 or C2 timed at one shape: event ms as called and device ms, the
    plain version's ms as called and on the device (its replays as a
    captured graph: :func:`graph_device_ms`), and the bound: the state read
    once (one row when broadcast), the indices and the (11, B, 13 or 14, n)
    int32 output written once."""
    from graal_tpu_torch.core.candidates import build_candidates_plain, mh_candidates_plain
    from graal_tpu_torch.ops.candidates_cuda import CATALOGUE

    plain = {"em": build_candidates_plain, "mh": mh_candidates_plain}[kind]
    b, n = fb.shape[0], state.n_frags
    rows = 1 if state.pos.dim() == 1 else state.pos.shape[0]
    slots = 13 + bool(with_base)
    t = timed(lambda: CATALOGUE(kind, state, fa, fb, max_id, with_base), CAT_TIME_ITERS)
    t["plain_ms"] = cuda_ms(lambda: plain(state, fa, fb, max_id, with_base), 5, n_warm=1)
    t["plain_device_ms"] = graph_device_ms(lambda: plain(state, fa, fb, max_id, with_base), 20)
    idx = sum(x.numel() * x.element_size() for x in (fa, fb, max_id)
              if hasattr(x, "numel"))
    n_bytes = 11 * 4 * rows * n + idx + 11 * 4 * b * slots * n
    return dict(with_share(t, bound(n_bytes)), B=b, n=n, state_rows=rows, slots=slots,
                max_abs_err=0)


def prefix_genome(truth, n):
    """A valid genome of the first ``n`` fragments of the true genome, cut
    into three pieces (one piece when n < 3)."""
    from graal_tpu_torch.core.state import GenomeState

    return cut_truth(GenomeState(*[x[:n] for x in truth]), {0: [n // 3, 2 * n // 3]})


def reset_counted(wrapper, calls):
    """Set a self-counting wrapper's counters and the calls made to it to 0."""
    wrapper.n_launches = 0
    calls.clear()


def check_counted(label, wrapper, calls):
    """The launches a self-counting kernel kept on the card equal the calls
    the phase made to it, by key."""
    import torch

    torch.cuda.synchronize()
    got = {str(k): v for k, v in wrapper.launches.by_key().items() if str(k) in calls}
    check(got == calls, f"{label}: the kernels counted {got} launches, the phase made {calls}")
    print(f"  launches kept by the kernels on the card: {got}, equal to the calls made")


def catalogue_deltas(sc, gen, f_max, starts):
    """C1 and C2 on the delta engine's mini-states of a step of each chain
    of ``starts`` at bucket ``f_max``, with the whole genome's maximum,
    with and without the base slot, and on CAT_PAIRS random pairs of them.
    Returns (the step's (minis, lf_a, lf_b, max_id), the pairs compared)."""
    import torch
    from graal_tpu_torch.core.state import GenomeState

    st = GenomeState(*[torch.stack(xs) for xs in zip(*starts)])
    f_as = torch.randint(0, sc["n"], (len(starts),), generator=gen, device=st.pos.device)
    minis, lf_a, lf_b, mx = mini_states(st, f_as, sc["runner"].nb, gen, f_max)
    for wb in (False, True):
        catalogue_vs_plain(f"delta step at R = {f_max}", minis, lf_a, lf_b, mx, with_base=wb)
    pairs = catalogue_pairs(f"delta minis at R = {f_max}", minis, gen, max_id=mx, with_base=True)
    print(f"  delta mini-states at R = {f_max}, M = {minis.pos.shape[0]} ({len(starts)} "
          "chain(s)), the genome's maximum, with and without the base slot")
    return (minis, lf_a, lf_b, mx), pairs


def phase_catalogue(device, sc):
    """3c. The catalogue kernels C1 (the EM catalogue) and C2 (the MH one)
    against their plain versions, all 11 fields bit for bit, at every
    shape a sampler path gives them and at the edges of the kernels'
    partition (CAT_EDGE_N), ~CAT_PAIRS random (f_a, f_b) pairs a shape (one
    in ten with f_a == f_b) besides the steps' own neighbours; the
    launches the kernels counted equal to the calls made; then timed
    against the plain versions."""
    import torch
    from graal_tpu_torch.core import mcmc, mtm
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem, problem_jump_table, repeat_problem

    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    reset_counted(catalogue_wrapper(), CAT_CALLS)
    state, table, _, obs, nb = problem(n_bins=384, device=device)
    start = mcmc.explode_genome(state)
    circ = circularised(state)
    n = state.n_frags
    pairs = 0
    print(f"catalogue kernels C1 (em) and C2 (mh) vs plain, 11 fields bit for bit; "
          f"{CAT_PAIRS} random pairs a shape")
    # the EM step's call: one genome over its neighbour slots, f_a 0-d
    for label, st in (("flagship", state), ("exploded", start), ("circularised", circ)):
        for f in torch.randperm(n, generator=gen, device=device)[:8]:
            ids, _ = mcmc.sample_neighbours(gen, f, st, nb, DELTA)
            catalogue_vs_plain(f"{label} step at {int(f)}", st, f, ids)
        pairs += catalogue_pairs(label, st, gen)
    print(f"  flagship ({n} fragments): the true genome, its exploded start and a circularised "
          "contig: steps of 8 fragments over their neighbour slots, random pairs")
    # the partition's edges: one fragment, one past a block (K = 2: the
    # second block holds one fragment), one past eight blocks (K = 8: block
    # 0 loops over two chunks, the second of one fragment); one row a
    # genome, the whole state's maximum
    for n_cut in CAT_EDGE_N:
        st = prefix_genome(sc["truth"], n_cut)
        for f in torch.randint(0, n_cut, (4,), generator=gen, device=device):
            ids = torch.randint(0, n_cut, (DELTA + 1,), generator=gen, device=device)
            catalogue_vs_plain(f"n = {n_cut} step at {int(f)}", st, f, ids)
        pairs += catalogue_pairs(f"n = {n_cut}", st, gen)
    st = prefix_genome(sc["truth"], CAT_EDGE_N[1])
    rows = GenomeState(*[torch.stack(xs) for xs in zip(*[
        (st, mcmc.explode_genome(st), circularised(st))[k % 3] for k in range(CAT_EDGE_ROWS)])])
    pairs += catalogue_pairs(f"{CAT_EDGE_ROWS} rows of n = {CAT_EDGE_N[1]}", rows, gen)
    print(f"  edges: n = {', '.join(map(str, CAT_EDGE_N))} cut from the 100k truth (K = "
          f"{', '.join(str(catalogue_plan(k)) for k in CAT_EDGE_N)}); {CAT_EDGE_ROWS} rows of "
          f"n = {CAT_EDGE_N[1]}, the maximum the whole state's")
    # repeat copies: swap activity, inactive copies
    rstate, _, _, _, rnb = repeat_problem(n_bins=384, device=device)
    copies = torch.nonzero(rstate.rep == 1).reshape(-1)
    inactive = rstate._replace(activ=torch.where(
        (rstate.rep == 1) & (torch.arange(rstate.n_frags, device=device) % 2 == 0),
        0, rstate.activ))
    for label, st in (("repeat", rstate), ("repeat, inactive copies", inactive),
                      ("repeat, circularised", circularised(inactive, 1))):
        for f in copies[:4]:
            ids, _ = mcmc.sample_neighbours(gen, f, st, rnb, DELTA)
            catalogue_vs_plain(f"{label} step at copy {int(f)}", st, f, ids)
        pairs += catalogue_pairs(label, st, gen, frags=copies)
    print(f"  repeat table ({rstate.n_frags} copy rows, {copies.numel()} copies): active, every "
          "other copy inactive, a circularised contig")
    # 4 chains: one genome per (chain, neighbour) row, each chain's maximum
    chains = GenomeState(*[torch.stack(xs) for xs in zip(state, start, circ, start)])
    f_as = torch.randint(0, n, (CHAINS,), generator=gen, device=device)
    ids = torch.stack([mcmc.sample_neighbours(gen, f_as[c], GenomeState(*[x[c] for x in chains]),
                                              nb, DELTA)[0] for c in range(CHAINS)])
    m = ids.shape[1]
    per_nb = GenomeState(*[x.repeat_interleave(m, 0) for x in chains])
    max_c = chains.id_c.amax(-1).repeat_interleave(m)
    catalogue_vs_plain("4 chains step", per_nb, f_as.repeat_interleave(m), ids.reshape(-1),
                       max_c)
    pairs += catalogue_pairs("4 chains", per_nb, gen, max_id=max_c)
    print(f"  {CHAINS} chains: {CHAINS * m} rows, each with its chain's maximum")
    # the MH catalogue on the MTM passes' neighbour sets
    jump = problem_jump_table(state, table, obs, MTM_DELTA)
    for label, st in (("flagship", state), ("exploded", start)):
        for f in torch.randperm(n, generator=gen, device=device)[:8]:
            ids, _ = mtm._neighbour_set(st, f, jump)
            catalogue_vs_plain(f"MTM pass of {label} at {int(f)}", st, f, ids)
    mini, lf_a, lf_b, mx = collision_mini(device)
    got = catalogue_vs_plain("section C's collision input", mini, lf_a, lf_b, mx)["mh"]
    check(got.id_c[0, 10].tolist() == [4, 4] and got.circ[0, 10].tolist() == [1, 1],
          f"section C's input: candidate 10 is {got.id_c[0, 10].tolist()}, "
          f"circ {got.circ[0, 10].tolist()}")
    print(f"  MTM / MH passes on the jump table ({MTM_DELTA} partners + prev / next), "
          "and section C's collision input (candidate 10 relabelled 4, circular)")
    # delta mini-states with the whole genome's maximum
    deltas = {}
    for f_max, starts in ((F_MAX, (sc["shuf"],)),
                          (TOP_TIERS[1], (sc["truth"], sc["tiered"], sc["halves"], sc["shuf"]))):
        deltas[f_max], got = catalogue_deltas(sc, gen, f_max, starts)
        pairs += got
    print(f"  {pairs} random pairs and every step's neighbours: C1 and C2 equal to their plain "
          "versions bit for bit")
    check_counted("3c", catalogue_wrapper(), CAT_CALLS)

    rec = {}
    f = torch.tensor(int(torch.randint(0, n, (1,), generator=gen, device=device)), device=device)
    ids, _ = mcmc.sample_neighbours(gen, f, state, nb, DELTA)
    rec["em_flagship"] = catalogue_record("em", state, f, ids)
    rows = per_nb.pos.shape[0]
    rec[f"em_tempered_{CHAINS}_chains"] = catalogue_record(
        "em", per_nb, torch.randint(0, n, (rows,), generator=gen, device=device),
        torch.randint(0, n, (rows,), generator=gen, device=device), max_c)
    mids, _ = mtm._neighbour_set(state, f, jump)
    rec["mh_flagship"] = catalogue_record("mh", state, f, mids)
    for f_max, (minis, lf_a, lf_b, mx) in deltas.items():
        rec[f"em_delta_R{f_max}_M{minis.pos.shape[0]}"] = catalogue_record(
            "em", minis, lf_a, lf_b, mx, with_base=True)
    minis, lf_a, lf_b, mx = deltas[F_MAX]
    sub = GenomeState(*[x[:len(lf_a)] for x in minis])
    rec[f"mh_delta_R{F_MAX}_M{len(lf_a)}"] = catalogue_record("mh", sub, lf_a, lf_b, mx,
                                                              with_base=True)
    for name, r in rec.items():
        print(f"  {name}: B = {r['B']}, n = {r['n']}, {r['slots']} slots: "
              f"{r['device_ms']:.4f} device ms ({r['ms']:.4f} as called), plain "
              f"{r['plain_device_ms']:.4f} device ms ({r['plain_ms']:.4f} as called); "
              f"{fmt_bound(r)}")
    return rec


def catalogue_plan(n):
    """C1 / C2's blocks a genome for n fragments (ops/candidates_cuda.plan)."""
    from graal_tpu_torch.ops.candidates_cuda import plan

    return plan(n)


def phase_catalogue_top(sc):
    """(``--top-tiers``) C1 and C2 at B = 20, n = 16,384: the mini-states
    of a step of 4 chains (the truth, the tiered and halved cuts, the
    shuffle) at bucket 16,384, bit for bit as in 3c, the launches counted
    equal to the calls made; C1 timed there against its plain version."""
    import torch

    gen = torch.Generator(device=sc["truth"].pos.device).manual_seed(SEED + 31)
    reset_counted(catalogue_wrapper(), CAT_CALLS)
    (minis, lf_a, lf_b, mx), pairs = catalogue_deltas(
        sc, gen, TOP_TIERS[1], (sc["truth"], sc["tiered"], sc["halves"], sc["shuf"]))
    check_counted("3c top", catalogue_wrapper(), CAT_CALLS)
    rec = catalogue_record("em", minis, lf_a, lf_b, mx, with_base=True)
    print(f"  C1 at B = {rec['B']}, n = {rec['n']}: {pairs} random pairs bit for bit; "
          f"{rec['device_ms']:.4f} device ms, plain {rec['plain_device_ms']:.4f}; "
          f"{fmt_bound(rec)}")
    return dict(rec, pairs=pairs)


def select_cluster(size):
    """D3's blocks a chain (ops/step_cuda.select_cluster)."""
    from graal_tpu_torch.ops.step_cuda import select_cluster as k

    return k(size)


def step_wrapper():
    """The step kernels' wrapper (the head, D3, the tail; launches keyed by
    kind)."""
    from graal_tpu_torch.ops.step_cuda import STEP

    return STEP


def step_launches():
    """The step kernels' launches by key so far, read from the card."""
    return {str(k): v for k, v in step_wrapper().launches.by_key().items()}


def want_step_launches(label, got, steps, delta=False):
    """Check a main path's step kernel launches: one head and one selection
    a step (the delta or the dense one), and on a dense path one tail a
    step (with or without the nuisance step). Records them for the kernels
    line."""
    want = {"step_head": steps, "select_delta" if delta else "select_dense": steps}
    if not delta:
        want["step_tail"] = steps
    print(f"  step kernel launches: {got} (one of each a step: {steps})")
    check(got == want, f"{label}: step kernel launches {got} != {want}")
    STEP_PATHS[label.replace(" ", "_")] = got


def step_called(kind, k=1):
    """Record ``k`` calls made to the step kernel ``kind`` (each one launch
    that the kernel counts itself)."""
    STEP_CALLS[kind] = STEP_CALLS.get(kind, 0) + int(k)


def gumbel_noise(shape, gen, device):
    import torch

    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def random_temperatures(c, gen, device, k):
    """Draw ``k``'s temperature: a Python float in turn with a tensor of one
    a draw in [0.3, 4] (the cycles' f_t buffers)."""
    import torch

    if k % 2 == 0:
        return (1.0, 0.8, 2.5)[k // 2 % 3]
    return 0.3 + 3.7 * torch.rand(c, generator=gen, device=device)


def slot_margin(label, sel_k, sel_p, keys, n_pos):
    """The drawn slots held to the margin rule: the kernel's slot must
    equal the plain version's unless the categorical draw decides (more
    than one slot in the window) and the two best keys lie within SLOT_ULPS
    ulps of the best, where either of the two passes. Returns (the rows
    whose slots agree, the rows under the margin)."""
    import torch

    top = torch.topk(keys, 2, dim=-1)
    best, second = top.values[:, 0], top.values[:, 1]
    ulp = torch.nextafter(best.abs(), torch.full_like(best, float("inf"))) - best.abs()
    close = (n_pos > 1) & torch.isfinite(best) & (best - second <= SLOT_ULPS * ulp)
    agree = sel_k == sel_p
    either = (sel_k == top.indices[:, 0]) | (sel_k == top.indices[:, 1])
    bad = ~agree & ~(close & either)
    check(not bool(bad.any()), f"{label}: the drawn slot differs from the plain version's on "
          f"{int(bad.sum())} draws outside the margin (first {bad.nonzero()[:4].tolist()})")
    return agree, close


def same_rows(label, what, got, want, rows):
    """``got`` and ``want`` equal bit for bit (NaN equal to NaN) and of one
    dtype on the rows ``rows``. Returns the largest absolute difference
    measured on those rows (inf where a NaN meets a number)."""
    import torch

    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{label}: {what} is {got.dtype} {tuple(got.shape)}, plain {want.dtype} "
          f"{tuple(want.shape)}")
    g, w = got[rows], want[rows]
    if g.is_floating_point():
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        diff = (g.double() - w.double()).abs().nan_to_num(nan=math.inf)
    else:
        same = g == w
        diff = (g.double() - w.double()).abs()
    err = float(torch.where(same, 0.0, diff).max()) if same.numel() else 0.0
    bad = ~same
    n_bad = int(bad.flatten(1).any(-1).sum()) if bad.dim() > 1 else int(bad.sum())
    check(bool(same.all()), f"{label}: {what} differs from the plain version on {n_bad} draws")
    return err


def step_draw_inputs(state, nb, gen, frags=None):
    """(u, f_a) of a draw: uniforms and a fragment, half of them from
    ``frags`` (repeat copies) when given."""
    import torch

    dev = state.pos.device
    u = torch.rand(nb.pk.shape[1], generator=gen, device=dev)
    f = torch.randint(0, state.n_frags, (), generator=gen, device=dev)
    if frags is not None and len(frags) and bool(torch.rand((), generator=gen, device=dev) < 0.5):
        f = frags[int(torch.randint(0, len(frags), (), generator=gen, device=dev))]
    return u, f


def check_neighbour_draws(label, state, nb, gen, n_draws=STEP_DRAWS, frags=None):
    """The head's draw alone against its plain version on ``n_draws``
    random (u, f_a) of
    ``state`` (fields (n,): one genome; (C, n): the draws shared out over
    the chains), each chain's draws in one call on a chains axis of its
    genome broadcast; and one draw alone through sample_neighbours. Half
    the fragments from ``frags`` (repeat copies) when given. Returns (the
    draws compared, the largest difference measured on them)."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState

    dev = state.pos.device
    n = state.n_frags
    chains = [state] if state.pos.dim() == 1 else [GenomeState(*[x[c] for x in state])
                                                   for c in range(state.pos.shape[0])]
    k = -(-n_draws // len(chains))
    step = step_wrapper()
    err = 0.0
    for c, one in enumerate(chains):
        f_a = torch.randint(0, n, (k,), generator=gen, device=dev)
        if frags is not None and len(frags):
            f_a[::2] = frags[torch.randint(0, len(frags), (k,), generator=gen,
                                           device=dev)][::2]
        u = torch.rand((k, nb.pk.shape[1]), generator=gen, device=dev)
        st = GenomeState(*[x.expand(k, n) for x in one])
        ids, valid = step.neighbours(u, f_a, st.id_d, st.rep, nb, DELTA)
        step_called("step_head")
        want = mcmc.sample_neighbours_plain(u, f_a, st, nb, DELTA)
        every = torch.ones(k, dtype=torch.bool, device=dev)
        err = max(err, same_rows(f"{label}, chain {c}", "ids", ids, want[0], every),
                  same_rows(f"{label}, chain {c}", "valid", valid, want[1], every))
        got = mcmc.sample_neighbours(u[0], f_a[0], one, nb, DELTA)
        step_called("step_head", f_a.is_cuda)
        want = mcmc.sample_neighbours_plain(u[0], f_a[0], one, nb, DELTA)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{label}: one draw through sample_neighbours differs from the plain version")
    return k * len(chains), err


def dense_steps(state, nb, scorer, params, gen, n_steps=4, chains=False, frags=None):
    """The dense tail's real inputs: ``n_steps`` EM steps' neighbours (the
    plain draw), catalogues (C1) and scores (the path's scorer); with
    ``chains`` one step of every chain of ``state`` (C, n) at once."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.candidates import N_CANDIDATES, build_candidates
    from graal_tpu_torch.core.state import GenomeState

    out = []
    for _ in range(n_steps):
        if chains:
            c, n = state.pos.shape
            u = torch.rand((c, nb.pk.shape[1]), generator=gen, device=state.pos.device)
            f_a = torch.randint(0, n, (c,), generator=gen, device=state.pos.device)
            ids, valid = mcmc.sample_neighbours_plain(u, f_a, state, nb, DELTA)
            m = ids.shape[1]
            per_nb = GenomeState(*[x.repeat_interleave(m, 0) for x in state])
            cands = build_candidates(per_nb, f_a.repeat_interleave(m), ids.reshape(-1),
                                     max_id=state.id_c.amax(-1).repeat_interleave(m))
        else:
            u, f_a = step_draw_inputs(state, nb, gen, frags)
            ids, valid = mcmc.sample_neighbours_plain(u, f_a, state, nb, DELTA)
            cands = build_candidates(state, f_a, ids)
        flat = GenomeState(*[x.reshape(-1, state.n_frags) for x in cands])
        ll = scorer(flat, params).reshape(ids.shape + (N_CANDIDATES,))
        out.append(dict(state=state, flat=flat, ll=ll, ids=ids, valid=valid,
                        f_a=f_a.long()))
    return out


def random_dense_steps(state, gen, n_steps=2):
    """The dense tail's inputs without a scorer: DELTA + 1 random neighbour
    slots of a random f_a of ``state`` (fields (n,)), four in five valid,
    their catalogue (C1) and random scores about -1,000 with a spread of 5
    (most slots inside the 30-window, as a step's)."""
    import torch
    from graal_tpu_torch.core.candidates import N_CANDIDATES, build_candidates
    from graal_tpu_torch.core.state import GenomeState

    dev = state.pos.device
    n, m = state.n_frags, DELTA + 1
    out = []
    for _ in range(n_steps):
        f_a = torch.randint(0, n, (), generator=gen, device=dev)
        ids = torch.randint(0, n, (m,), generator=gen, device=dev, dtype=torch.int32)
        valid = torch.rand(m, generator=gen, device=dev) < 0.8
        flat = GenomeState(*[x.reshape(-1, n) for x in build_candidates(state, f_a, ids)])
        ll = -1000.0 + 5.0 * torch.randn((m, N_CANDIDATES), generator=gen, device=dev)
        out.append(dict(state=state, flat=flat, ll=ll, ids=ids, valid=valid, f_a=f_a.long()))
    return out


def check_dense_tails(label, steps, blacklist, gen, n_draws=STEP_DRAWS):
    """D3's dense entry against select_commit_dense_plain on ``n_draws``
    draws (Gumbel noise, temperature) over the real steps ``steps``, in
    calls of STEP_CHUNK draws (a chains axis of one step's genome, or of its
    chains, repeated), a quarter of the calls with f_a blacklisted: the
    drawn slot under the margin rule, and wherever it agrees the new state,
    score, op and fb bit for bit. And one step through select_commit_dense,
    under the same rule. Returns (draws, draws under the margin, the largest
    difference measured where the slots agree)."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.candidates import N_CANDIDATES
    from graal_tpu_torch.core.state import GenomeState

    step = step_wrapper()
    done = close_n = 0
    err = 0.0
    k = 0
    while done < n_draws:
        s = steps[k % len(steps)]
        state, ids = s["state"], s["ids"]
        dev = ids.device
        c0 = 1 if ids.dim() == 1 else ids.shape[0]
        reps = max(1, STEP_CHUNK // c0)
        c = c0 * reps
        n = state.n_frags
        m = ids.shape[-1]
        sl = m * N_CANDIDATES

        def tile(x):
            if c0 == 1:     # one genome: its rows broadcast
                return x[None].expand((c,) + tuple(x.shape))
            return x.repeat((reps,) + (1,) * (x.dim() - 1))

        st = GenomeState(*[tile(x) for x in state])
        flat = GenomeState(*[tile(x.reshape(sl, n)) if c0 == 1 else
                             tile(x.reshape(c0, sl, n)) for x in s["flat"]])
        ll, ids_c, valid = tile(s["ll"]), tile(ids), tile(s["valid"])
        f_a = tile(s["f_a"]).contiguous()
        gum = gumbel_noise((c, sl), gen, dev)
        f_t = random_temperatures(c, gen, dev, k)
        bl = blacklist.clone()
        if k % 4 == 3:
            bl[f_a] = True
        fields, score, op, fb, sel = step.select_dense(st, flat, ll, ids_c, valid, f_a, gum,
                                                       f_t, bl, mcmc.THRESH_OVERFLOW)
        STEP_CALLS["select_dense"] = STEP_CALLS.get("select_dense", 0) + 1
        want, (w_score, w_op, w_fb), w_sel = mcmc.select_commit_dense_plain(
            st, GenomeState(*[x.reshape(c * sl, n) for x in flat]), ll, ids_c, valid, f_a,
            gum, f_t, bl)
        del flat
        keys, n_pos, _ = mcmc.slot_keys(gum, ll, valid, f_t)
        agree, close = slot_margin(f"{label}, call {k}", sel, w_sel, keys, n_pos)
        for name, g, w in zip(GenomeState._fields, fields, want):
            err = max(err, same_rows(f"{label}, call {k}", name, g, w, agree))
        for name, g, w in (("score", score, w_score), ("op", op, w_op), ("fb", fb, w_fb),
                           ("sel", sel, w_sel)):
            err = max(err, same_rows(f"{label}, call {k}", name, g, w, agree))
        done += c
        close_n += int(close.sum())
        k += 1
    s = steps[0]
    if s["ids"].dim() == 1:
        gum = gumbel_noise((s["ids"].shape[0] * N_CANDIDATES,), gen, s["ids"].device)
        args = (s["state"], s["flat"], s["ll"], s["ids"], s["valid"], s["f_a"], gum, 1.0,
                blacklist)
        got, want = mcmc.select_commit_dense(*args), mcmc.select_commit_dense_plain(*args)
        # the public function launches D3 on a card only
        STEP_CALLS["select_dense"] = STEP_CALLS.get("select_dense", 0) + s["ids"].is_cuda
        keys, n_pos, _ = mcmc.slot_keys(gum, s["ll"], s["valid"], 1.0)
        agree, close = slot_margin(f"{label}, one step through select_commit_dense",
                                   got[2].reshape(1), want[2].reshape(1), keys.reshape(1, -1),
                                   n_pos.reshape(1))
        if bool(agree):
            check(all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
                  and all(torch.equal(a, b) for a, b in zip(got[1], want[1])),
                  f"{label}: one step through select_commit_dense differs from plain")
        done += 1
        close_n += int(close.sum())
    return done, close_n, err


def delta_steps(scorer, states, nb, params, extract, gen, f_as=None):
    """One delta step's real tail inputs for every chain of ``states`` (C,
    n): each chain's f_a (a contig extremity by default), its neighbours
    (the plain draw), member rows (``extract``) and scored mini-states
    (``scorer.score``); and the distinct-rows contract checked on them."""
    import torch
    from graal_tpu_torch.core import mcmc

    dev = states.pos.device
    c = states.pos.shape[0]
    f_a = chain_extremities(states, 1) if f_as is None else f_as
    u = torch.rand((c, nb.pk.shape[1]), generator=gen, device=dev)
    ids, valid = mcmc.sample_neighbours_plain(u, f_a, states, nb, DELTA)
    rows, rvalid, over = extract(states, f_a, ids, scorer.f_max)
    dll, minis, rows, rows_valid, overflow = scorer.score(
        states, f_a, ids, rows, rvalid, over, params, states.id_c.amax(-1))
    # each chain's valid rows of a neighbour slot are distinct (the delta commit's contract)
    f_max = rows.shape[-1]
    tagged = torch.where(rows_valid, rows, -1 - torch.arange(f_max, device=dev))
    ordered = tagged.sort(-1).values
    check(bool((ordered[..., 1:] != ordered[..., :-1]).all()),
          "a chain's valid member rows repeat: the delta commit's contract fails")
    return dict(states=states, f_a=f_a.long(), ids=ids, valid=valid, dll=dll, minis=minis,
                rows=rows, rows_valid=rows_valid, overflow=overflow)


def check_delta_tails(label, s, blacklist, gen, n_draws=STEP_DRAWS):
    """D3's delta entry against select_commit_delta_plain on ``n_draws``
    draws over the real step ``s`` (from :func:`delta_steps`): in calls of
    STEP_DELTA_CHUNK draws of one chain (its inputs repeated, the genome
    copied so that the kernel writes each draw's own), a quarter of the
    calls with f_a blacklisted and a quarter with every slot overflowing:
    the drawn slot under the margin rule, and wherever it agrees the 8
    written fields, d_sel, op, fb and n_over bit for bit. Returns (draws,
    draws under the margin, the largest difference measured where the slots
    agree)."""
    import torch
    from graal_tpu_torch.core import delta, mcmc
    from graal_tpu_torch.core.state import MUTABLE_FIELDS, GenomeState

    step = step_wrapper()
    states = s["states"]
    c0, n = states.pos.shape
    dev = states.pos.device
    k = done = close_n = 0
    err = 0.0
    while done < n_draws:
        ch = k % c0
        c = STEP_DELTA_CHUNK

        def rep(x):
            return x[ch:ch + 1].expand((c,) + tuple(x.shape[1:]))

        st = GenomeState(*[rep(x) for x in states])
        minis = GenomeState(*[rep(x) for x in s["minis"]])
        rows, rows_valid = rep(s["rows"]).contiguous(), rep(s["rows_valid"]).contiguous()
        dll, ids, valid, f_a = rep(s["dll"]), rep(s["ids"]), rep(s["valid"]), rep(s["f_a"])
        overflow = rep(s["overflow"])
        if k % 4 == 2:
            overflow = torch.ones_like(overflow)
        bl = blacklist.clone()
        if k % 4 == 3:
            bl[f_a] = True
        gum = gumbel_noise((c, ids.shape[1] * 13), gen, dev)
        f_t = random_temperatures(c, gen, dev, k)
        dst = {f: x.clone() for f, x in st._asdict().items()}
        d_sel, op, fb, n_over, sel = step.select_delta(
            dst, minis._asdict(), rows, rows_valid, dll, ids, valid, overflow, f_a, gum, f_t,
            bl, mcmc.THRESH_OVERFLOW)
        STEP_CALLS["select_delta"] = STEP_CALLS.get("select_delta", 0) + 1
        want, w_dsel, (w_op, w_fb, w_over), w_sel = delta.select_commit_delta_plain(
            st, minis, rows, rows_valid, dll, ids, valid, overflow, f_a, gum, f_t, bl,
            mcmc.THRESH_OVERFLOW)
        slot_ok = (~overflow)[..., None].expand(-1, -1, 13)
        keys, n_pos, _ = mcmc.slot_keys(gum, dll, valid, f_t, slot_valid=slot_ok)
        agree, close = slot_margin(f"{label}, call {k}", sel, w_sel, keys, n_pos)
        for f in MUTABLE_FIELDS:
            err = max(err, same_rows(f"{label}, call {k}", f, dst[f], getattr(want, f), agree))
        for name, g, w in (("d_sel", d_sel, w_dsel), ("op", op, w_op), ("fb", fb, w_fb),
                           ("n_over", n_over, w_over), ("sel", sel, w_sel)):
            err = max(err, same_rows(f"{label}, call {k}", name, g, w, agree))
        done += c
        close_n += int(close.sum())
        k += 1
    return done, close_n, err


def check_nuisance_moves(label, params, gen, n_draws=STEP_DRAWS, cap=None, log_nfpb=None,
                         l_ref=-1.0e5):
    """The head's proposal alone and the tail's Metropolis test alone (what
    ``make_nuisance_step`` and the runners' cycle end launch) against
    nuisance_propose_plain / nuisance_accept_plain on
    ``n_draws`` draws (id_modif, eps, u; l_star around l_ref and a
    temperature) of the parameters ``params`` (one set, or one a chain: the
    draws cycle through the chains): the 5 test parameters, in_support and
    the parameter row, then the accepted parameters, l_t and accept, bit for
    bit (NaN equal to NaN); one move alone through the public functions.
    Returns (draws, {test field: draws that differ}, the largest difference
    measured) for the record."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.model import RippeParams

    step = step_wrapper()
    dev = params.fact.device
    c0 = params.fact.numel()
    at = torch.arange(n_draws, device=dev) % c0
    par = RippeParams(*[x.reshape(-1).index_select(0, at) for x in params])
    idm = torch.randint(0, 4, (n_draws,), generator=gen, device=dev)
    eps = torch.randn(n_draws, generator=gen, device=dev)
    every = torch.ones(n_draws, dtype=torch.bool, device=dev)
    (c1, slope, d_max, fact, v_inter), ok, row = step.nuisance_propose(idm, eps, par, cap,
                                                                       log_nfpb)
    step_called("step_head")
    got = par._replace(c1=c1, slope=slope, d_max=d_max, fact=fact, v_inter=v_inter)
    want, w_ok, w_row = mcmc.nuisance_propose_plain(idm, eps, par, cap, log_nfpb)
    diffs = {f: int((getattr(got, f) != getattr(want, f)).sum()) for f in
             ("c1", "slope", "d_max", "fact", "v_inter")}
    err = 0.0
    for f in RippeParams._fields:
        err = max(err, same_rows(label, f"test {f}", getattr(got, f), getattr(want, f), every))
    err = max(err, same_rows(label, "in_support", ok, w_ok, every))
    if log_nfpb is not None:
        err = max(err, same_rows(label, "parameter row", row, w_row, every))
    u = torch.rand(n_draws, generator=gen, device=dev)
    l_t = l_ref + torch.randn(n_draws, generator=gen, device=dev)
    l_star = l_t + 3.0 * torch.randn(n_draws, generator=gen, device=dev)
    for k, f_t in enumerate((0.8, 0.5 + 3.0 * torch.rand(n_draws, generator=gen,
                                                          device=dev))):
        out, l_out, acc = step.nuisance_accept(u, got, par, l_star, l_t, f_t, ok)
        step_called("step_tail")
        w_out, w_l, w_acc = mcmc.nuisance_accept_plain(u, want, par, l_star, l_t, f_t, w_ok)
        for f, g, w in zip(RippeParams._fields, out, w_out):
            err = max(err, same_rows(f"{label}, accept {k}", f, g, w, every))
        err = max(err, same_rows(f"{label}, accept {k}", "l_t", l_out, w_l, every),
                  same_rows(f"{label}, accept {k}", "accept", acc, w_acc, every))
        check(0 < int(acc.sum()) < n_draws, f"{label}: accepts {int(acc.sum())}/{n_draws}")
    one = RippeParams(*[x[0] for x in par])
    got1 = mcmc.nuisance_propose(idm[0], eps[0], one, cap, log_nfpb)
    step_called("step_head", dev.type == "cuda")
    want1 = mcmc.nuisance_propose_plain(idm[0], eps[0], one, cap, log_nfpb)
    check(all(bool((a == b) | (a != a)) for a, b in zip(got1[0], want1[0]))
          and bool(got1[1] == want1[1]), f"{label}: one proposal through nuisance_propose "
          "differs from the plain version")
    return n_draws, diffs, err


def tail_genomes(one, k, gen):
    """``k`` genomes for the tail's metrics: ``one``'s, every third one
    exploded, each with its own random activity."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState

    dev, n = one.pos.device, one.n_frags
    third = (torch.arange(k, device=dev) % 3 == 2)[:, None]
    ex = mcmc.explode_genome(one)
    st = GenomeState(*[torch.where(third, b.expand(k, n), a.expand(k, n))
                       for a, b in zip(one, ex)])
    return st._replace(activ=(torch.rand((k, n), generator=gen, device=dev) < 0.8).int())


def check_tail(label, l_t, score, accept, tails):
    """The tail against step_tail_plain on one call's inputs (``tails``
    the genomes of its metrics or None), every output bit for bit. Returns
    the largest difference measured."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.model import RippeParams

    metrics = None if tails is None else (tails.pos, tails.activ, tails.len_bp)
    fields, l_out, acc, n_contigs, mean_len = step_wrapper().step_tail(l_t, score, accept,
                                                                       metrics)
    step_called("step_tail")
    want = mcmc.step_tail_plain(l_t, score, accept, tails)
    every = torch.ones(l_out.numel(), dtype=torch.bool, device=l_out.device)
    outs = [("l_t", l_out, want.l_t), ("accepted", acc, want.accepted)]
    if tails is not None:
        outs += [("n_contigs", n_contigs, want.n_contigs), ("mean_len", mean_len, want.mean_len)]
    if accept is not None:
        outs += [(f"accepted {f}", g, w) for f, g, w in zip(RippeParams._fields, fields,
                                                             want.params)]
    return max(same_rows(label, name, g.reshape(-1), w.reshape(-1), every)
               for name, g, w in outs)


def tail_scores(k, gen, dev, l_ref):
    """(l_t, a score) of ``k`` chains around l_ref, the scores of a
    seventh of them -inf and of a tenth NaN (D3's score of a skipped step;
    the select keeps l_t)."""
    import torch

    l_t = l_ref + torch.randn(k, generator=gen, device=dev)
    score = l_t + torch.randn(k, generator=gen, device=dev)
    score[torch.rand(k, generator=gen, device=dev) < 0.15] = -math.inf
    score[torch.rand(k, generator=gen, device=dev) < 0.1] = math.nan
    return l_t, score


def check_head_tail(label, state, nb, params, gen, n_draws=STEP_DRAWS, frags=None,
                    log_nfpb=None, nuisance=True, l_ref=-1.0e5):
    """A dense step's head and tail against their plain versions on
    ``n_draws`` draws of ``state`` (fields (n,): one genome; (C, n): the
    draws shared out over the chains), each chain's draws in one call on a
    chains axis, half the fragments from ``frags`` when given: the head's
    draw and, with ``nuisance``, its proposal of ``params`` (one set, or
    one a chain: the draws cycle through them) in one launch; then the
    tail's l_t select (tail_scores), the Metropolis test of that proposal
    (random temperatures) and the metrics of tail_genomes; every output bit
    for bit (NaN equal to NaN). And one step of one genome through the
    public functions step_head / step_tail. Returns (the draws compared,
    the head's and the tail's largest difference measured)."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.model import RippeParams
    from graal_tpu_torch.core.state import GenomeState

    dev = state.pos.device
    n = state.n_frags
    chains = [state] if state.pos.dim() == 1 else [GenomeState(*[x[c] for x in state])
                                                   for c in range(state.pos.shape[0])]
    k = -(-n_draws // len(chains))
    c0 = 1 if params is None else params.fact.numel()
    step = step_wrapper()
    every = torch.ones(k, dtype=torch.bool, device=dev)
    err_head = err_tail = 0.0
    for c, one in enumerate(chains):
        lab = f"{label}, chain {c}"
        f_a = torch.randint(0, n, (k,), generator=gen, device=dev)
        if frags is not None and len(frags):
            f_a[::2] = frags[torch.randint(0, len(frags), (k,), generator=gen,
                                           device=dev)][::2]
        u = torch.rand((k, nb.pk.shape[1]), generator=gen, device=dev)
        st = GenomeState(*[x.expand(k, n) for x in one])
        nuis = None
        if nuisance:
            at = (torch.arange(k, device=dev) + c * k) % c0
            par = RippeParams(*[x.reshape(-1).index_select(0, at) for x in params])
            nuis = (torch.randint(0, 4, (k,), generator=gen, device=dev),
                    torch.randn(k, generator=gen, device=dev), par, None, log_nfpb)
        drawn, proposed = step.step_head((u, f_a, st.id_d, st.rep, nb, DELTA), nuis)
        step_called("step_head")
        w_drawn, w_prop = mcmc.step_head_plain(u, f_a, st, nb, DELTA, nuis)
        err_head = max(err_head, same_rows(lab, "ids", drawn[0], w_drawn[0], every),
                       same_rows(lab, "valid", drawn[1], w_drawn[1], every))
        l_t, score = tail_scores(k, gen, dev, l_ref)
        accept = None
        if nuisance:
            test = par._replace(**dict(zip(("c1", "slope", "d_max", "fact", "v_inter"),
                                           proposed[0])))
            for f in RippeParams._fields:
                err_head = max(err_head, same_rows(lab, f"test {f}", getattr(test, f),
                                                   getattr(w_prop[0], f), every))
            err_head = max(err_head, same_rows(lab, "in_support", proposed[1], w_prop[1], every))
            if log_nfpb is not None:
                err_head = max(err_head, same_rows(lab, "parameter row", proposed[2], w_prop[2],
                                                   every))
            accept = (torch.rand(k, generator=gen, device=dev), test, par,
                      l_t + 3.0 * torch.randn(k, generator=gen, device=dev),
                      random_temperatures(k, gen, dev, c), proposed[1])
        err_tail = max(err_tail, check_tail(lab, l_t, score, accept, tail_genomes(one, k, gen)))
    # one step of one genome through the public functions
    one = chains[0]
    u, f = step_draw_inputs(one, nb, gen, frags)
    nuis = None if not nuisance else (
        torch.randint(0, 4, (), generator=gen, device=dev),
        torch.randn((), generator=gen, device=dev),
        RippeParams(*[x.reshape(-1)[0] for x in params]), None, log_nfpb)
    got, want = mcmc.step_head(u, f, one, nb, DELTA, nuis), mcmc.step_head_plain(
        u, f.long(), one, nb, DELTA, nuis)
    step_called("step_head", dev.type == "cuda")
    same = all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    if nuisance:
        same = same and all(bool((a == b) | (a != a)) for a, b in zip(got[1][0], want[1][0]))
    check(same, f"{label}: one step through step_head differs from the plain version")
    l1 = torch.tensor(l_ref, device=dev)
    acc1 = None if not nuisance else (torch.rand((), generator=gen, device=dev), want[1][0],
                                      nuis[2], l1 + 0.5, 1.0, want[1][1])
    got, want = mcmc.step_tail(l1, l1 + 1.0, acc1, one), mcmc.step_tail_plain(l1, l1 + 1.0,
                                                                            acc1, one)
    step_called("step_tail", dev.type == "cuda")
    check(all(torch.equal(a, b) for a, b in zip(got, want) if isinstance(a, torch.Tensor)),
          f"{label}: one step through step_tail differs from the plain version")
    return k * len(chains), err_head, err_tail


def check_tail_edges(label, one, params, gen, n_draws=STEP_CHUNK):
    """The tail at a genome size that its block reduction has an edge at:
    ``n_draws`` genomes of ``one`` (tail_genomes), their l_t select and a
    Metropolis test of parameters 1% off ``params``, against the plain
    version bit for bit. Returns the largest difference measured."""
    import torch
    from graal_tpu_torch.core.model import RippeParams

    dev = one.pos.device
    par = RippeParams(*[x.reshape(1).expand(n_draws).contiguous() for x in params])
    test = RippeParams(*[x * 1.01 for x in par])
    l_t, score = tail_scores(n_draws, gen, dev, -1.0e5)
    accept = (torch.rand(n_draws, generator=gen, device=dev), test, par,
              l_t + torch.randn(n_draws, generator=gen, device=dev), 0.8,
              torch.rand(n_draws, generator=gen, device=dev) < 0.8)
    return check_tail(label, l_t, score, accept, tail_genomes(one, n_draws, gen))


def step_bound(kind, c, m=0, n=0, f_max=0, n_top=10, mc=1, n_solve=0, n_rows=0, c_prop=0,
               row=False, score=False, c_acc=0, f_t_read=False):
    """The least time of one call (bound()): bytes each input is read and
    each output written once. The head: ``c`` chains' draws (their keys'
    pk / xk / u, f_a's bin and rep, the drawn partners' copies, the entries'
    blacklist flags, ids and valid written) and ``c_prop`` chains'
    proposals (the parameter row written only with ``row``, when
    log_nfpb is given), with the curve evaluations their outputs need: one
    multisection solve (64 points x 5 passes, each ~16 FP32 and 4
    special-function operations: two exponentials and a power of two
    operations) for each of the ``n_solve`` chains whose id_modif needs one
    (the d_max proposal needs none), and a chain's kuhn^-3 (a power). The
    tail: ``c`` chains' l_t (and ``score``), ``c_acc`` chains' Metropolis
    tests (the 16 parameters, u, l* and in_support read, f_t too when it
    is a tensor (``f_t_read``; a number is folded into the launch's
    arguments), one exponential, the 8 parameters written; l_t is counted
    once, above) and, with ``n``, the three int32
    fields of each chain's n fragments read and two metrics written. D3's
    delta entry reads the chosen slot's f_max row flags and, for each of
    the ``n_rows`` valid rows it commits, the row index and the 8 fields,
    and writes the 8 fields."""
    s = 13 * m
    if kind == "step_head":
        n_bytes = c * (n_top * 4 + 8 + 8 + 2 * n_top * 4 + (DELTA + 1) * mc * 4 + m + m * 5) \
            + c_prop * (8 * 4 + 8 + 4 + 5 * 4 + 1 + 10 * 4 * row)
        return bound(n_bytes, fp32_ops=n_solve * 64 * 5 * 16,
                     sfu_ops=n_solve * 64 * 5 * 4 + c_prop)
    if kind == "step_tail":
        n_bytes = c * (4 + 4 * score + 4 + 1) \
            + c_acc * (16 * 4 + 2 * 4 + 4 * f_t_read + 1 + 8 * 4) \
            + (c * (3 * 4 * n + 8 + 4) if n else 0)
        return bound(n_bytes, sfu_ops=c_acc)
    if kind == "select_dense":    # scores, noise, masks; the chosen candidate read, a state written
        n_bytes = c * (2 * s * 4 + m * 5 + 8 + 1 + 2 * 11 * 4 * n + 4 * 8)
        return bound(n_bytes)
    # select_delta: the chosen slot's row flags; its valid rows' index and fields
    n_bytes = c * (2 * s * 4 + m * 6 + 8 + 1 + f_max + 5 * 8) + n_rows * (8 + 2 * 8 * 4)
    return bound(n_bytes)


def step_record(kind, fn, plain, b, **shape):
    """One step kernel timed at one shape: event ms as called and device ms,
    the plain version's ms as called and on the device (as graph replays),
    and the bound."""
    t = timed(fn, STEP_TIME_ITERS)
    t["plain_ms"] = cuda_ms(plain, 5, n_warm=1)
    t["plain_device_ms"] = graph_device_ms(plain, 20)
    return dict(with_share(t, b), kind=kind, **shape)


def time_head(s, params, nb, gen, draw=True, cap=None, log_nfpb=None, **shape):
    """The head at one step's shape (``s``: the step's ids and state, one
    genome or a chains axis): the draw (``draw``) and, with ``params`` (one
    set or one a chain), the proposal beside it, against step_head_plain
    (the proposal alone: nuisance_propose_plain)."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState

    step = step_wrapper()
    ids, state = s["ids"], s["state"]
    dev = ids.device
    c = 1 if ids.dim() == 1 else ids.shape[0]
    m = ids.shape[-1]
    dr = nuis = None
    if draw:
        u = torch.rand((c, nb.pk.shape[1]), generator=gen, device=dev)
        f_a = s["f_a"].reshape(c)
        st = GenomeState(*[x.expand(c, -1) for x in state]) if state.pos.dim() == 1 else state
        dr = (u, f_a, st.id_d, st.rep, nb, DELTA)
    n_solve = c_prop = 0
    if params is not None:
        c_prop = max(c, params.fact.numel())
        par = type(params)(*[x.reshape(-1).expand(c_prop).contiguous() for x in params])
        idm = torch.randint(0, 4, (c_prop,), generator=gen, device=dev)
        nuis = (idm, torch.randn(c_prop, generator=gen, device=dev), par, cap, log_nfpb)
        n_solve = int((idm != 2).sum())

    def plain():
        if dr is None:
            return mcmc.nuisance_propose_plain(*nuis)
        return mcmc.step_head_plain(u, f_a, st, nb, DELTA, nuis)

    b = step_bound("step_head", c if draw else 0, m=m, n_top=nb.pk.shape[1] if draw else 0,
                   mc=nb.max_copies if draw else 0, n_solve=n_solve, c_prop=c_prop,
                   row=log_nfpb is not None)
    return step_record("step_head", lambda: step.step_head(dr, nuis), plain, b,
                       C=max(c if draw else 0, c_prop), m=m if draw else 0, n_solve=n_solve,
                       draw=draw, propose=nuis is not None, **shape)


def time_tail(c, gen, dev, params=None, tails=None, score=True, f_t=1.0, **shape):
    """The tail of ``c`` chains: the l_t select on a score (``score``), the
    Metropolis test of parameters 1% off ``params`` (one set or one a
    chain) when given, the metrics of ``tails`` ((c, n) genomes) when
    given; against step_tail_plain."""
    import torch
    from graal_tpu_torch.core import mcmc

    step = step_wrapper()
    l_t, sc_ = tail_scores(c, gen, dev, -1.0e5)
    sc_ = sc_ if score else None
    accept = None
    if params is not None:
        par = type(params)(*[x.reshape(-1).expand(c).contiguous() for x in params])
        accept = (torch.rand(c, generator=gen, device=dev), type(params)(*[x * 1.01 for x in par]),
                  par, l_t + torch.randn(c, generator=gen, device=dev), f_t,
                  torch.ones(c, dtype=torch.bool, device=dev))
    metrics = None if tails is None else (tails.pos, tails.activ, tails.len_bp)
    n = 0 if tails is None else tails.n_frags
    b = step_bound("step_tail", c, n=n, score=score, c_acc=c if accept else 0,
                   f_t_read=isinstance(f_t, torch.Tensor))
    return step_record("step_tail", lambda: step.step_tail(l_t, sc_, accept, metrics),
                       lambda: mcmc.step_tail_plain(l_t, sc_, accept, tails), b, C=c, n=n,
                       score=score, accept=accept is not None, metrics=tails is not None,
                       **shape)


def time_select_dense(s, blacklist, gen, **shape):
    """D3's dense entry at one step's shape against its plain version."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.candidates import N_CANDIDATES
    from graal_tpu_torch.core.state import GenomeState

    step = step_wrapper()
    ids, state = s["ids"], s["state"]
    dev = ids.device
    single = ids.dim() == 1
    c = 1 if single else ids.shape[0]
    m = ids.shape[-1]
    lift = (lambda x: x[None]) if single else (lambda x: x)
    st = GenomeState(*[lift(x) for x in state])
    flat = GenomeState(*[x.reshape(c, m * N_CANDIDATES, -1) for x in s["flat"]])
    ll, idc, valid, f_a = lift(s["ll"]), lift(ids), lift(s["valid"]), s["f_a"].reshape(c)
    gum = gumbel_noise((c, m * N_CANDIDATES), gen, dev)
    return step_record(
        "select_dense", lambda: step.select_dense(st, flat, ll, idc, valid, f_a, gum, 1.0,
                                                  blacklist, mcmc.THRESH_OVERFLOW),
        lambda: mcmc.select_commit_dense_plain(st, s["flat"], ll, idc, valid, f_a, gum, 1.0,
                                               blacklist),
        step_bound("select_dense", c, m=m, n=state.n_frags), C=c, m=m, n=state.n_frags,
        **shape)


def time_delta_step(s, blacklist, gen, **shape):
    """D3's delta entry at one real step's shape (every chain), into a copy
    of the genome it rewrites each call, against its plain version; the
    bound counts the valid rows of the slots the kernel drew."""
    import torch
    from graal_tpu_torch.core import delta, mcmc

    step = step_wrapper()
    c, m = s["ids"].shape
    f_max = s["rows"].shape[-1]
    gum = gumbel_noise((c, m * 13), gen, s["ids"].device)
    dst = {f: x.clone() for f, x in s["states"]._asdict().items()}
    minis = s["minis"]._asdict()
    args = (s["rows"], s["rows_valid"], s["dll"], s["ids"], s["valid"], s["overflow"], s["f_a"],
            gum, 1.0, blacklist, mcmc.THRESH_OVERFLOW)
    _, op, _, _, sel = step.select_delta(dst, minis, *args)
    chosen = s["rows_valid"][torch.arange(c, device=sel.device), sel // 13]
    n_rows = int((chosen.sum(-1) * (op != -1)).sum())
    return step_record("select_delta", lambda: step.select_delta(dst, minis, *args),
                       lambda: delta.select_commit_delta_plain(s["states"], s["minis"], *args),
                       step_bound("select_delta", c, m=m, f_max=f_max, n_rows=n_rows), C=c, m=m,
                       f_max=f_max, n_rows=n_rows, **shape)


def phase_step_kernels(device, sc, rsc, n_bins=384):
    """3d. The step kernels against their plain versions on each EM-family
    path's own inputs: the head (draw and proposal) and the tail (l_t,
    Metropolis test, metrics) on the dense flagship and the dense repeat
    twin, the draw alone and the tail's select and metrics on 4 tempered
    chains, the draw alone on the copy-dense table, the 100k delta path,
    its 4 chains and the 20k repeat twin, the proposal alone and the test
    alone at the runner's cycle end with the chains and the cap, the tail at
    the edge genome sizes; D3 on every path and at its cluster's edges;
    ~STEP_DRAWS random draws a shape, the drawn slot under the margin rule;
    then each timed against its plain version at the path's shape."""
    import torch
    from graal_tpu_torch.core import delta, delta_repeats, mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem, repeat_problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    reset_counted(step_wrapper(), STEP_CALLS)
    print(f"step kernels: the head (draw, proposal), D3 (select_commit) and the tail (l_t, "
          f"acceptance, metrics) vs plain, {STEP_DRAWS} draws a shape; slots equal outside "
          f"{SLOT_ULPS} ulps of the best key")
    rec, close = {}, {}
    nuis_diffs = {}
    # the largest difference measured against the plain versions, by kernel
    errs = dict(step_head=0.0, step_tail=0.0, select_commit=0.0)

    def measured(kernel, err):
        errs[kernel] = max(errs[kernel], err)

    def neighbour_draws(*args, **kw):
        measured("step_head", check_neighbour_draws(*args, **kw)[1])

    def heads_tails(label, *args, **kw):
        draws, e_head, e_tail = check_head_tail(label, *args, **kw)
        measured("step_head", e_head)
        measured("step_tail", e_tail)
        print(f"  {label}: {draws} draws, head and tail bit for bit")

    def note(name, got):
        draws, under, err = got
        close[name] = under
        measured("select_commit", err)
        print(f"  {name}: {draws} draws, {under} under the margin")

    # the dense flagship (B1, B = 65) and the dense repeat twin (B3, B = 130)
    dense_cases = []
    for name, build in (("dense_flagship", problem), ("dense_repeat", repeat_problem)):
        state, table, params, obs, nb = build(n_bins=n_bins, device=device)
        scorer = make_dense_scorer(table, obs, device)
        start = mcmc.explode_genome(state)
        copies = torch.nonzero(state.rep == 1).reshape(-1)
        for label, st in ((name, state), (f"{name}, exploded", start)):
            heads_tails(f"{label} head / tail", st, nb, params, gen, n_draws=STEP_DRAWS // 2,
                        frags=copies, log_nfpb=scorer.log_nfpb)
        steps = (dense_steps(state, nb, scorer, params, gen, frags=copies)
                 + dense_steps(start, nb, scorer, params, gen, frags=copies))
        note(f"{name} D3", check_dense_tails(f"{name} D3", steps, nb.blacklist, gen))
        n_d, nuis_diffs[name], err = check_nuisance_moves(f"{name} proposal / test alone",
                                                          params, gen, log_nfpb=scorer.log_nfpb)
        measured("step_head", err)
        measured("step_tail", err)
        print(f"  {name} proposal / test alone: {n_d} moves, bit for bit")
        dense_cases.append((name, steps[0], params, scorer, nb))
    # D3's partition and the tail's reduction at their edges: n = 1, 257 and
    # 2,049 (D3: K = 1, 2, 8, a second block of one fragment, block 0 looping
    # to fragment 2,048; the tail: one fragment, 256 threads' second round)
    for n_cut in CAT_EDGE_N:
        st = prefix_genome(sc["truth"], n_cut)
        note(f"n = {n_cut} D3", check_dense_tails(
            f"n = {n_cut} D3 (K = {select_cluster(n_cut)})",
            random_dense_steps(st, gen), torch.zeros(n_cut, dtype=torch.bool, device=device),
            gen))
        measured("step_tail", check_tail_edges(f"n = {n_cut} tail", st, sc["params"], gen))
        print(f"  n = {n_cut} tail: {STEP_CHUNK} genomes bit for bit")
    # 4 tempered chains of the flagship (B1 at B = 260, per-chain f_t): the
    # draw alone, the tail's select and metrics
    state, table, params, obs, nb = problem(n_bins=n_bins, device=device)
    scorer = make_dense_scorer(table, obs, device)
    chains = GenomeState(*[torch.stack(xs) for xs in zip(
        state, mcmc.explode_genome(state), circularised(state), mcmc.explode_genome(state))])
    heads_tails("tempered head / tail", chains, nb, None, gen, nuisance=False)
    neighbour_draws("tempered draw", chains, nb, gen)
    t_steps = dense_steps(chains, nb, scorer, params, gen, chains=True)
    note("tempered D3", check_dense_tails("tempered D3", t_steps, nb.blacklist, gen))
    # the copy-dense table: 15 extra copies of a bin (max_copies 16, m = 80)
    cd_state, _, _, _, cd_nb = copy_dense_problem(device)
    check(cd_nb.max_copies == 16, f"copy-dense table: max_copies {cd_nb.max_copies}")
    copies = torch.nonzero(cd_state.rep == 1).reshape(-1)
    neighbour_draws("copy-dense draw (m = 80)", cd_state, cd_nb, gen, frags=copies)
    # and with 40 partners a bin: the keys ranked through shared memory, 41 x
    # 16 candidate entries, 21 a lane
    neighbour_draws("copy-dense draw, n_top 40", cd_state,
                    copy_dense_problem(device, n_top=40)[4], gen, frags=copies)
    # the delta paths: 100k (M = 5), 4 chains (M = 20)
    runner = sc["runner"]
    scorer = delta.make_delta_scorer(sc["table"], None, F_MAX, sobs=sc["sobs"])
    shuf = sc["shuf"]
    neighbour_draws("100k draw", shuf, runner.nb, gen)
    d100 = delta_steps(scorer, GenomeState(*[x[None] for x in shuf]), runner.nb, sc["params"],
                       delta.extract_rows_union, gen)
    note("100k delta D3", check_delta_tails("100k delta D3 (M = 5)", d100, runner.nb.blacklist,
                                            gen))
    states = chain_starts(sc)
    pc = chain_params(sc["params"])
    neighbour_draws("4 chains draw", states, runner.nb, gen)
    d4 = delta_steps(scorer, states, runner.nb, pc, delta.extract_rows_union, gen)
    note("4 chains D3", check_delta_tails("4 chains D3 (M = 20)", d4, runner.nb.blacklist, gen))
    # the delta commit over a cluster: bucket 4,096 (K = 8, 2 rows a thread)
    # on the tiered cut
    scorer_top = delta.make_delta_scorer(sc["table"], None, TOP_F_MAX, sobs=sc["sobs"])
    d_top = delta_steps(scorer_top, GenomeState(*[x[None] for x in sc["tiered"]]), runner.nb,
                        sc["params"], delta.extract_rows_union, gen)
    del scorer_top
    k_top = select_cluster(TOP_F_MAX)
    note(f"100k D3 at {TOP_F_MAX}", check_delta_tails(
        f"100k D3 at {TOP_F_MAX} (M = 5, K = {k_top})", d_top, runner.nb.blacklist, gen))
    # the cycle end: 4 chains' own parameters, the cap, per-chain f_t (the
    # proposal alone, the test alone)
    cap = runner.max_covered_d_max
    cap = None if cap == float("inf") else cap
    l_ref = float(runner.chains_anchor_fn()(states, pc)[0])
    n_d, nuis_diffs["cycle_end"], err = check_nuisance_moves(
        "cycle end proposal / test (4 chains, cap)", pc, gen, cap=cap, l_ref=l_ref)
    measured("step_head", err)
    measured("step_tail", err)
    print(f"  cycle end: {n_d} moves of {CHAINS} chains' parameters, cap {cap}")
    # the 20k repeat twin (the repeat engine v2, extract_rows_each, M = 10)
    engine = delta_repeats.make_repeat_delta_scorer_v2(rsc["table"], F_MAX, rsc["sobs"],
                                                       rsc["shuf"].rep)
    copies = torch.nonzero(rsc["shuf"].rep == 1).reshape(-1)
    neighbour_draws("20k repeat draw", rsc["shuf"], rsc["runner"].nb, gen, frags=copies)
    d20 = delta_steps(engine, GenomeState(*[x[None] for x in rsc["shuf"]]), rsc["runner"].nb,
                      rsc["params"], delta.extract_rows_each, gen, f_as=copies[:1].long())
    note("20k repeat D3", check_delta_tails("20k repeat D3 (M = 10)", d20,
                                            rsc["runner"].nb.blacklist, gen))
    print(f"  the head, D3 and the tail equal to their plain versions; drawn slots under the "
          f"margin {close}; test parameters that differ {nuis_diffs}; largest differences "
          f"measured {errs}")
    check_counted("3d", step_wrapper(), STEP_CALLS)
    # times at each path's shape
    for name, s, d_params, d_scorer, d_nb in dense_cases:
        rec[f"step_head_{name}"] = time_head(s, d_params, d_nb, gen, log_nfpb=d_scorer.log_nfpb,
                                             path=name)
        rec[f"select_dense_{name}"] = time_select_dense(s, d_nb.blacklist, gen, path=name)
        rec[f"step_tail_{name}"] = time_tail(1, gen, device, params=d_params,
                                             tails=tail_genomes(s["state"], 1, gen), path=name)
    rec["step_head_tempered"] = time_head(t_steps[0], None, nb, gen, path="tempered")
    rec["select_dense_tempered"] = time_select_dense(t_steps[0], nb.blacklist, gen,
                                                     path="tempered")
    rec["step_tail_tempered"] = time_tail(CHAINS, gen, device, tails=chains,
                                          path="tempered")
    rec["step_head_cycle_end"] = time_head(dict(ids=d4["ids"], state=states), pc, runner.nb,
                                           gen, draw=False, cap=cap, path="cycle_end")
    rec["step_tail_cycle_end"] = time_tail(CHAINS, gen, device, params=pc, score=False,
                                           path="cycle_end")
    for name, s, nbt in (("100k", d100, runner.nb), ("chains_100k", d4, runner.nb),
                         (f"100k_{TOP_F_MAX}", d_top, runner.nb),
                         ("repeat_20k", d20, rsc["runner"].nb)):
        rec[f"step_head_{name}"] = time_head(
            dict(ids=s["ids"], state=s["states"], f_a=s["f_a"]), None, nbt, gen, path=name)
        rec[f"select_delta_{name}"] = time_delta_step(s, nbt.blacklist, gen, path=name)
    for name, r in rec.items():
        print(f"  {name}: C = {r['C']}: {r['device_ms']:.4f} device ms ({r['ms']:.4f} as "
              f"called), plain {r['plain_device_ms']:.4f} device ms ({r['plain_ms']:.4f} as "
              f"called); {fmt_bound(r)}")
    return dict(records=rec, close=close, nuisance_diffs=nuis_diffs, errs=errs)


def copy_dense_problem(device, n_bins=48, copies=15, n_top=10):
    """A genome over ``n_bins`` bins with ``copies`` extra copies of bin 7
    (max_copies 16: a step's m = 80 neighbour slots), its contacts and
    neighbour table of ``n_top`` partners a bin; every fragment of bin 7
    flagged rep."""
    import numpy as np
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState

    rng = np.random.default_rng(SEED + 41)
    id_d = np.concatenate([np.arange(n_bins), np.full(copies, 7)]).astype(np.int32)
    n = len(id_d)
    m = rng.poisson(2.0, (n_bins, n_bins)).astype(np.float32)
    m = np.triu(m, 1) + np.triu(m, 1).T
    per = 8
    soa = dict(pos=np.arange(n) % per, id_c=np.arange(n) // per,
               start_bp=(np.arange(n) % per) * 1000, len_bp=np.full(n, 1000),
               circ=np.zeros(n), l_cont=np.minimum(per, n - (np.arange(n) // per) * per),
               l_cont_bp=np.minimum(per, n - (np.arange(n) // per) * per) * 1000,
               ori=np.ones(n), rep=(id_d == 7).astype(np.int32), activ=np.ones(n), id_d=id_d)
    state = GenomeState.from_soa(soa, device=device)
    nb = mcmc.build_neighbour_table(m, id_d, n, blacklisted=[3, n - 1], n_top=n_top,
                                    device=device)
    return state, None, None, None, nb


def phase_step_top(sc):
    """(``--top-tiers``) D3's delta entry on 4 chains from the truth at
    bucket 16,384 (M = 20) against its plain version, and timed there."""
    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.core.state import GenomeState

    gen = torch.Generator(device=sc["truth"].pos.device).manual_seed(SEED + 42)
    reset_counted(step_wrapper(), STEP_CALLS)
    runner = sc["runner"]
    scorer = delta.make_delta_scorer(sc["table"], None, TOP_TIERS[1], sobs=sc["sobs"])
    states = GenomeState(*[x.expand(CHAINS, -1).contiguous() for x in sc["truth"]])
    s = delta_steps(scorer, states, runner.nb, chain_params(sc["params"]),
                    delta.extract_rows_union, gen)
    draws, under, err = check_delta_tails(f"{CHAINS} chains D3 at {TOP_TIERS[1]} (M = 20)", s,
                                          runner.nb.blacklist, gen)
    check_counted("3d top", step_wrapper(), STEP_CALLS)
    rec = time_delta_step(s, runner.nb.blacklist, gen, path=f"chains_{TOP_TIERS[1]}")
    print(f"  {CHAINS} chains at bucket {TOP_TIERS[1]}: {draws} draws, {under} under the "
          f"margin, largest difference {err}; {rec['device_ms']:.4f} device ms, plain "
          f"{rec['plain_device_ms']:.4f}; {fmt_bound(rec)}")
    return dict(rec, draws=draws, close=under, max_abs_err=err)


def move_wrapper():
    """The MTM / MH step kernels' wrapper (E1-E3, launches keyed by kind)."""
    from graal_tpu_torch.ops.mtm_cuda import MOVE

    return MOVE


def move_launches():
    """The MTM / MH step kernels' launches by key so far, read from the card."""
    return {str(k): v for k, v in move_wrapper().launches.by_key().items()}


def want_move_launches(label, got, steps):
    """Check a main path's E1-E3 launches: two neighbour sets (the forward
    set, the backward mask or set), one draw and one acceptance a step.
    Records them for the kernels line."""
    want = {"set": 2 * steps, "draw": steps, "accept": steps}
    print(f"  MTM / MH kernel launches: {got} (two sets, one draw, one accept a step: "
          f"{steps})")
    check(got == want, f"{label}: MTM / MH kernel launches {got} != {want}")
    MOVE_PATHS[label.replace(" ", "_")] = got


def move_keys(variant, ll_flat, discard_flat, f_t, gumbel, clamp):
    """The plain version's draw keys log(p, or 1e-30) + Gumbel of a forward
    pass (the delta forms clamp the weights' sum at 1e-30)."""
    import torch
    from graal_tpu_torch.core import mtm

    w, sw, _ = mtm._forward_weights(variant, ll_flat, discard_flat, f_t)
    p = w / (sw.clamp_min(1e-30) if clamp else sw)
    return torch.log(torch.where(p > 0, p, 1e-30)) + gumbel


def draw_close(keys):
    """The two best keys within MOVE_ULPS ulps of the best: the drawn slot
    may be either of them."""
    import numpy as np
    import torch

    top = torch.topk(keys, 2)
    best, second = float(top.values[0]), float(top.values[1])
    return math.isfinite(best) and best - second <= MOVE_ULPS * float(
        np.spacing(np.float32(abs(best)))), top.indices.tolist()


def accept_close(r_k, r_p, u):
    """The acceptance may go either way: min(ratio, 1) of the plain version
    within MOVE_ULPS ulps of u, or u between the kernel's and the plain
    version's (their weight sums differ in the last ulps)."""
    import numpy as np

    ck, cp, u = min(float(r_k), 1.0), min(float(r_p), 1.0), float(u)
    if math.isnan(ck) or math.isnan(cp):
        return False
    ulp = MOVE_ULPS * float(np.spacing(np.float32(u)))
    return abs(cp - u) <= ulp or min(ck, cp) - ulp <= u <= max(ck, cp) + ulp


def exact(label, what, got, want):
    """``got`` and ``want`` equal bit for bit (NaN equal to NaN), of one
    dtype and shape."""
    import torch

    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{label}: {what} is {got.dtype} {tuple(got.shape)}, plain {want.dtype} "
          f"{tuple(want.shape)}")
    same = (got == want) | (torch.isnan(got) & torch.isnan(want)) if got.is_floating_point() \
        else got == want
    check(bool(same.all()), f"{label}: {what} differs from the plain version")


def rel_diff(a, b):
    """|a - b| / max(|b|, 1e-30) in f64 on the card, 0 where a and b are
    equal or both NaN."""
    import torch

    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return torch.where(same, 0.0, (a - b).abs() / b.abs().clamp_min(1e-30))


def abs_diff(a, b):
    """|a - b| in f64 on the card, 0 where a and b are equal or both NaN."""
    import torch

    a, b = a.double(), b.double()
    return torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)), 0.0, (a - b).abs())


def same_on_card(label, pairs):
    """A 0-d bool on the card: each (name, got, want) of ``pairs`` equal bit
    for bit (NaN equal to NaN). Dtypes and shapes are checked here; the
    pairs of one dtype and shape are compared as one stack. The value is
    read later with the rest of a pivot's (:func:`read_all`); where it is
    false, :func:`exact_pairs` names the pair."""
    import torch

    groups = {}
    for name, g, w in pairs:
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{label}: {name} is {g.dtype} {tuple(g.shape)}, plain {w.dtype} {tuple(w.shape)}")
        gs, ws = groups.setdefault((g.dtype, tuple(g.shape)), ([], []))
        gs.append(g)
        ws.append(w)
    flags = []
    for gs, ws in groups.values():
        g, w = torch.stack(gs), torch.stack(ws)
        same = g == w
        if g.is_floating_point():
            same |= torch.isnan(g) & torch.isnan(w)
        flags.append(same.all())
    return torch.stack(flags).all()


def exact_pairs(label, pairs):
    for name, g, w in pairs:
        exact(label, name, g, w)


def read_all(values):
    """The 0-d tensors ``values`` as Python floats, in one read from the card."""
    import torch

    if not values:
        return []
    return torch.stack([v.reshape(()).to(torch.float64) for v in values]).tolist()


def move_case(label, kind, variant, state, jump, params, score, l_t, pivots, corrected=False):
    """One shape of phase 3e: ``score`` is the dense pass's scores_for or
    the delta pass's score_set (core.mtm), ``pivots`` the fragments drawn
    from (an int64 tensor on the card)."""
    return dict(label=label, kind=kind, variant=variant, state=state, jump=jump, params=params,
                score=score, l_t=l_t, pivots=pivots, corrected=corrected)


def move_temperature(d, gen, device):
    """Draw ``d``'s temperature: a Python float in turn with a 0-d f32
    tensor in [0.3, 4] (a cycle's f_t buffer)."""
    import torch

    if d % 2 == 0:
        return (1.0, 0.8, 2.5)[d // 2 % 3]
    return 0.3 + 3.7 * torch.rand((), generator=gen, device=device)


def check_move_kernels(case, gen, n_draws=MOVE_DRAWS, n_pivots=MOVE_PIVOTS):
    """E1-E3 against their plain versions on ``n_draws`` random draws of a
    shape: n_pivots pivots (E1 in its full mode on each, the forward pass
    scored once by the path's scorer), n_draws / n_pivots draws on each
    (Gumbel noise, uniform, temperature): E2 (the drawn slot under the
    margin rule, then f*, ll*, the forward maximum, ok and g*'s 11 fields
    bit for bit), E1 on g* (the mask-only mode, or the full one pivoted at
    f* for corrected MTM), the backward pass scored once a drawn slot, and
    E3 (the acceptance under its margin rule, then the new state, l_t and
    n_contigs bit for bit; a rejected delta step leaves the state it was
    written into equal to the input). One draw in eight discards every
    forward slot, one in eight every backward slot, one in eight of a
    delta shape has every neighbour overflow. The comparisons run on the
    card and are read twice a pivot (after the forward halves of its
    draws, after the backward halves); a draw whose slot or acceptance
    differs goes through its margin rule, and a comparison that fails is
    read again pair by pair to name it. Returns the record."""
    import torch
    from graal_tpu_torch.core import mtm

    move = move_wrapper()
    st, jump, params = case["state"], case["jump"], case["params"]
    variant, corrected, label = case["variant"], case["corrected"], case["label"]
    dense = case["kind"] == "dense"
    dev = st.pos.device
    l_t = case["l_t"]
    per = max(1, n_draws // n_pivots)
    stats = dict(draws=0, slot_close=0, accept_close=0, compared=0, accepted=0,
                 all_discarded=0, empty_backward=0, all_overflow=0)
    errs = dict(sw=0.0, p_fwd=0.0, ratio=0.0, p_fwd_abs=0.0, nonfinite=0)
    set_names = ("ids", "valid", "discard", "max_id", "n_contigs")

    def note(key, diff):
        if math.isfinite(diff):
            errs[key] = max(errs[key], diff)
        else:
            errs["nonfinite"] += 1

    pivots = case["pivots"]
    last = None
    for k in range(n_pivots):
        f_a = pivots[torch.randint(0, len(pivots), (), generator=gen, device=dev)]
        got = move.set(st._asdict(), f_a, jump.frags, f_a)
        want = mtm.move_set_plain(st, f_a, jump, f_a)
        set_pairs = list(zip(set_names, got, want))
        queued = [same_on_card(f"{label} E1", set_pairs)]
        nb_ids, nb_valid, discard_f, max_id, n_c = got
        if dense:
            cands, ll = case["score"](st, f_a, nb_ids, params)
        else:
            dll, minis, rows, rvalid, over = case["score"](st, f_a, nb_ids, params, max_id)
        # the forward halves of the pivot's draws, E2
        draws = []
        for j in range(per):
            d = k * per + j
            mode = d % 8
            s = nb_ids.shape[0] * 13
            gum = gumbel_noise((s,), gen, dev)
            u = torch.rand((), generator=gen, device=dev)
            f_t = move_temperature(d, gen, dev)
            disc = torch.ones_like(discard_f) if mode == 5 else discard_f
            stats["all_discarded"] += mode == 5
            stats["draws"] += 1
            if dense:
                fk = mtm._draw_dense_on_card(variant, ll, disc, f_t, gum, nb_ids, cands)
                fp = mtm.forward_dense_plain(variant, ll, disc, f_t, gum, nb_ids, cands)
                ovf = None
            else:
                ovf = torch.ones_like(over) if mode == 6 else over
                stats["all_overflow"] += mode == 6
                fk = mtm._draw_delta_on_card(variant, dll, l_t, ovf, disc, f_t, gum, nb_ids,
                                             minis, rows, rvalid, st, False)
                fp = mtm.forward_delta_plain(variant, dll, l_t, ovf, disc, f_t, gum, nb_ids,
                                             minis, rows, rvalid, st)
            pairs = [(name, getattr(fk, name), getattr(fp, name))
                     for name in ("f_star", "ll_star", "mx") + (() if dense else ("ok",))]
            pairs += [(f"g* {name}", g, w) for name, g, w in zip(fk.g_star._fields, fk.g_star,
                                                                   fp.g_star)]
            draws.append(dict(d=d, mode=mode, gum=gum, u=u, f_t=f_t, disc=disc, ovf=ovf, fk=fk,
                              fp=fp, pairs=pairs))
            queued += [fk.omega, fp.omega, same_on_card(f"{label} E2, draw {d}", pairs),
                       rel_diff(fk.sw, fp.sw), rel_diff(fk.p_fwd, fp.p_fwd),
                       abs_diff(fk.p_fwd, fp.p_fwd)]
        vals = read_all(queued)
        if not vals[0]:
            exact_pairs(f"{label} E1", set_pairs)
        live = []
        for r, (om_k, om_p, same, sw, p_fwd, p_abs) in zip(draws, zip(*[iter(vals[1:])] * 6)):
            d, fk = r["d"], r["fk"]
            if om_k != om_p:
                if dense:
                    keys = move_keys(variant, ll.reshape(-1), r["disc"].reshape(-1), r["f_t"],
                                     r["gum"], False)
                else:
                    keys = move_keys(variant, (l_t + dll).reshape(-1),
                                     (r["disc"] | r["ovf"][:, None]).reshape(-1), r["f_t"],
                                     r["gum"], True)
                close, top = draw_close(keys)
                check(close and int(om_k) in top,
                      f"{label}, draw {d}: slot {int(om_k)} != plain {int(om_p)} outside "
                      f"the margin")
                stats["slot_close"] += 1
                continue
            if not same:
                exact_pairs(f"{label} E2, draw {d}", r["pairs"])
            note("sw", sw)
            note("p_fwd", p_fwd)
            note("p_fwd_abs", p_abs)
            r["omega"] = int(om_k)
            live.append(r)
        # the backward halves, E1 on g* and E3
        backward = {}
        queued = []
        for r in live:
            d, mode, fk, fp, u, f_t = r["d"], r["mode"], r["fk"], r["fp"], r["u"], r["f_t"]
            if variant == "mtm" and corrected:
                bk = move.set(fk.g_star._asdict(), fk.f_star, jump.frags, f_a)
                bw = mtm.move_set_plain(fp.g_star, fp.f_star, jump, f_a)
            else:
                bk = move.set(fk.g_star._asdict(), None, jump.frags, f_a, (nb_ids, nb_valid))
                bw = mtm.move_set_plain(fp.g_star, None, jump, f_a, (nb_ids, nb_valid))
            r["set_pairs"] = list(zip(set_names, bk, bw))
            pivot_b = fk.f_star if variant == "mtm" else f_a
            omega = r["omega"]
            if omega not in backward:      # the backward pass depends on the slot alone
                backward[omega] = (case["score"](fk.g_star, pivot_b, bk[0], params)[1] if dense
                                   else case["score"](fk.g_star, pivot_b, bk[0], params, bk[3]))
            disc_b = torch.ones_like(bk[2]) if mode == 7 else bk[2]
            stats["empty_backward"] += mode == 7
            if dense:
                ll_b = backward[omega]
                ak = mtm._accept_dense_on_card(variant, ll_b, disc_b, fk, st, l_t, f_t, u,
                                               corrected)
                ap = mtm.accept_dense_plain(variant, ll_b, disc_b, fp, st, l_t, f_t, u, corrected)
            else:
                dll_b, _, _, _, over_b = backward[omega]
                ak = mtm._accept_delta_on_card(variant, dll_b, over_b, disc_b, fk, l_t, f_t, u,
                                               corrected, n_c)
                ap = mtm.accept_delta_plain(variant, dll_b, over_b, disc_b, fp, l_t, f_t, u,
                                            corrected)
            r.update(bk=bk, ak=ak, ap=ap)
            r["acc_pairs"] = list(zip(st._fields, ak[0], ap[0])) + [
                ("l_t", ak[1], ap[1]), ("n_contigs", ak[3], ap[3])]
            r["rest_pairs"] = [] if dense else list(zip(st._fields, ak[0], st))
            queued += [same_on_card(f"{label} E1 backward, draw {d}", r["set_pairs"]), ak[2],
                       ap[2], rel_diff(ak[4], ap[4]),
                       same_on_card(f"{label} E3, draw {d}", r["acc_pairs"]),
                       same_on_card(f"{label} E3 rejected, draw {d}", r["rest_pairs"])
                       if r["rest_pairs"] else ak[2]]
        vals = read_all(queued)
        for r, (set_same, acc_k, acc_p, ratio, same, restored) in zip(live,
                                                                     zip(*[iter(vals)] * 6)):
            d, ak, ap, u = r["d"], r["ak"], r["ap"], r["u"]
            if not set_same:
                exact_pairs(f"{label} E1 backward, draw {d}", r["set_pairs"])
            if bool(acc_k) != bool(acc_p):
                check(accept_close(ak[4], ap[4], u),
                      f"{label}, draw {d}: accepted {bool(acc_k)} != plain {bool(acc_p)} with "
                      f"ratio {float(ak[4])} (plain {float(ap[4])}) and u {float(u)} outside "
                      f"the margin")
                stats["accept_close"] += 1
                continue
            note("ratio", ratio)
            if not same:
                exact_pairs(f"{label} E3, draw {d}", r["acc_pairs"])
            if not dense and not acc_k and not restored:   # a rejection restores the input
                exact_pairs(f"{label} E3 rejected, draw {d}", r["rest_pairs"])
            stats["compared"] += 1
            stats["accepted"] += bool(acc_k)
            if r["mode"] < 5:
                last = dict(f_a=f_a, nb=(nb_ids, nb_valid, discard_f, max_id, n_c), gum=r["gum"],
                            u=u, fk=r["fk"], bk=r["bk"], backward=backward[r["omega"]],
                            fwd_in=(ll, cands) if dense else (dll, minis, rows, rvalid, over))
    check(stats["compared"] >= n_draws // 2,
          f"{label}: only {stats['compared']} of {stats['draws']} draws compared")
    print(f"  {label}: {stats}; largest differences of the values summed in another order "
          f"(relative; p_fwd also absolute) {errs}")
    return dict(stats=stats, errs=errs, last=last)


def move_bound(kernel, s, m, n=0, f_max=0, n_rows=0, dense=True, restores=False):
    """The least time of one call (bound()): the bytes the function must
    move, each input read and each output written once. E1: the genome's
    contig ids and positions (the pivot's and the m slots' own fields are a
    few hundred bytes), the jump row and the outputs. E2: the m x 13
    scores, discard flags and Gumbel noise and the m ids; dense: g*'s 11 x
    n int32 read from the catalogue and written; delta: for each of the
    ``n_rows`` rows written, its index, the 8 mini fields, the 8 old
    values read and the 8 new and 8 saved values written. E3: the m x 13
    scores and flags; dense: the chosen one of g* and the state read
    (11 x n, chosen once the acceptance is known) and the new state
    written; delta: the rows' positions and saved positions, and the
    rows restored on a rejection."""
    if kernel == "set":
        return bound(8 * n + 4 * (m - 2) + 8 * m + m + 13 * m + 12)
    if kernel == "draw":
        b = 4 * s + s + 4 * s + 8 * m + 32
        b += 2 * 11 * 4 * n if dense else f_max + n_rows * (8 + 4 * 8 * 4)
        return bound(b)
    b = 4 * s + s + 48
    b += 2 * 11 * 4 * n if dense else f_max + n_rows * (8 + 2 * 4 + (8 * 4 * 2 if restores else 0))
    return bound(b)


def time_move_kernels(case, checked):
    """E1, E2 and E3 timed at one shape on the inputs of its last compared
    draw (as called and on the device), beside the plain versions' ms as
    called and as graph replays, and their bounds."""
    import torch
    from graal_tpu_torch.core import mtm

    move = move_wrapper()
    last = checked["last"]
    check(last is not None, f"{case['label']}: no draw to time")
    st, jump, params = case["state"], case["jump"], case["params"]
    variant, corrected, l_t = case["variant"], case["corrected"], case["l_t"]
    dense = case["kind"] == "dense"
    f_a, (nb_ids, nb_valid, discard_f, max_id, n_c) = last["f_a"], last["nb"]
    gum, u, fk, bk = last["gum"], last["u"], last["fk"], last["bk"]
    f_t = torch.ones((), device=st.pos.device)
    m, n = nb_ids.shape[0], st.n_frags
    s = 13 * m
    out = {}

    def record(kernel, fn, plain, b, **shape):
        t = timed(fn, MOVE_TIME_ITERS)
        t["plain_ms"] = cuda_ms(plain, 5, n_warm=1)
        t["plain_device_ms"] = graph_device_ms(plain, 20)
        out[kernel] = dict(with_share(t, b), **shape)

    record("set", lambda: move.set(st._asdict(), f_a, jump.frags, f_a),
           lambda: mtm.move_set_plain(st, f_a, jump, f_a), move_bound("set", s, m, n=n), n=n, m=m)
    if dense:
        ll, cands = last["fwd_in"]
        ll_b = last["backward"]
        record("draw", lambda: move.draw_dense(variant, ll, discard_f, gum, nb_ids, f_t,
                                                tuple(cands)),
               lambda: mtm.forward_dense_plain(variant, ll, discard_f, f_t, gum, nb_ids, cands),
               move_bound("draw", s, m, n=n), n=n, m=m)
        record("accept", lambda: move.accept_dense(variant, ll_b, bk[2], fk, tuple(fk.g_star),
                                                    tuple(st), l_t, u, f_t, corrected),
               lambda: mtm.accept_dense_plain(variant, ll_b, bk[2], fk, st, l_t, f_t, u,
                                              corrected),
               move_bound("accept", s, m, n=n), n=n, m=m)
        return out
    dll, minis, rows, rvalid, over = last["fwd_in"]
    dll_b, _, _, _, over_b = last["backward"]
    dst = {f: x.clone() for f, x in st._asdict().items()}
    n_rows = int(rvalid[int(fk.omega) // 13].sum())
    f_max = rows.shape[-1]
    fwd = move.draw_delta(variant, dll, l_t, over, discard_f, gum, nb_ids, f_t, minis._asdict(),
                          rows, rvalid, dst)
    fk_t = fk._replace(omega=fwd[1], ll_star=fwd[3], p_fwd=fwd[4], sw=fwd[5], mx=fwd[6],
                       ok=fwd[7], undo=fwd[0])
    record("draw", lambda: move.draw_delta(variant, dll, l_t, over, discard_f, gum, nb_ids, f_t,
                                           minis._asdict(), rows, rvalid, dst),
           lambda: mtm.forward_delta_plain(variant, dll, l_t, over, discard_f, f_t, gum, nb_ids,
                                           minis, rows, rvalid, st),
           move_bound("draw", s, m, f_max=f_max, n_rows=n_rows, dense=False), n=n, m=m,
           f_max=f_max, n_rows=n_rows)
    restores = not bool(move.accept_delta(variant, dll_b, over_b, bk[2], fk_t, dst, rows, rvalid,
                                          fk_t.undo, n_c, l_t, u, f_t, corrected)[1])
    record("accept", lambda: move.accept_delta(variant, dll_b, over_b, bk[2], fk_t, dst, rows,
                                               rvalid, fk_t.undo, n_c, l_t, u, f_t, corrected),
           lambda: mtm.accept_delta_plain(variant, dll_b, over_b, bk[2],
                                          fk._replace(undo=st), l_t, f_t, u, corrected),
           move_bound("accept", s, m, f_max=f_max, n_rows=n_rows, dense=False,
                      restores=restores), n=n, m=m, f_max=f_max, n_rows=n_rows, restores=restores)
    return out


def move_shape(case, gen, n_draws=MOVE_DRAWS):
    """Phase 3e's check and timing of one shape; the record (kept in
    MOVE_SHAPES under the shape's label) and its printed summary."""
    checked = check_move_kernels(case, gen, n_draws)
    times = time_move_kernels(case, checked)
    for kernel, r in times.items():
        print(f"    E{('set', 'draw', 'accept').index(kernel) + 1} {kernel}: "
              f"{r['device_ms']:.4f} device ms ({r['ms']:.4f} as called), plain "
              f"{r['plain_device_ms']:.4f} device ms as graph replays ({r['plain_ms']:.4f} as "
              f"called); {fmt_bound(r)}")
    rec = dict(stats=checked["stats"], errs=checked["errs"], kernels=times,
               variant=case["variant"], corrected=case["corrected"], kind=case["kind"])
    MOVE_SHAPES[case["label"]] = rec
    return rec


def dense_move_cases(device, n_bins=384):
    """Phase 3e's dense shapes: the flagship (B1 at B = 91 a pass) from the
    truth (MTM, and corrected MTM) and exploded (MH), with a circularised
    contig (pivots among its members: its ends wrap), and the repeat twin
    (B3) with pivots half among the copies."""
    import numpy as np
    import torch
    from graal_tpu_torch.core import mcmc, mtm
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem, problem_jump_table, repeat_problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    state, table, params, obs, _ = problem(n_bins=n_bins, device=device)
    scorer = make_dense_scorer(table, obs, device)
    jump = problem_jump_table(state, table, obs, MTM_DELTA)
    score = mtm._make_scores_for(table, obs, torch.float32, scorer)

    def like(st):
        return scorer(GenomeState(*[x[None] for x in st]), params)[0]

    every = torch.arange(state.n_frags, device=device)
    exploded = mcmc.explode_genome(state)
    circ = circularised(state, 0)
    ring = torch.nonzero(circ.id_c == circ.id_c[torch.nonzero(circ.circ == 1)[0, 0]]).reshape(-1)
    cases = [move_case("dense_flagship_mtm", "dense", "mtm", state, jump, params, score,
                       like(state), every),
             move_case("dense_flagship_mh", "dense", "mh", exploded, jump, params, score,
                       like(exploded), every),
             move_case("dense_flagship_mtm_corrected", "dense", "mtm", state, jump, params, score,
                       like(state), every, corrected=True),
             move_case("dense_circular_mh", "dense", "mh", circ, jump, params, score, like(circ),
                       ring)]
    rstate, rtable, rparams, robs, _ = repeat_problem(n_bins=n_bins, device=device)
    k = robs.shape[0] // 3
    bins = np.asarray(robs, np.float64).reshape(k, 3, k, 3).sum(axis=(1, 3))
    rjump = mtm.build_jump_table(bins, np.ones(k), rstate.id_d.cpu().numpy(), rstate.n_frags,
                                 MTM_DELTA, device=device)
    rscorer = make_dense_scorer(rtable, robs, device)
    copies = torch.nonzero(rstate.rep == 1).reshape(-1)
    rpiv = torch.cat([copies.repeat(max(1, rstate.n_frags // max(len(copies), 1))),
                      torch.arange(rstate.n_frags, device=device)])
    cases.append(move_case("dense_repeat_mtm", "dense", "mtm", rstate, rjump, rparams,
                           mtm._make_scores_for(rtable, robs, torch.float32, rscorer),
                           rscorer(GenomeState(*[x[None] for x in rstate]), rparams)[0], rpiv))
    return cases


def delta_move_case(label, sc, variant, f_max, corrected=False, state=None, n_draws=None):
    """A delta shape of phase 3e: ``sc``'s runner's jump table and engine
    as ``ScaleRunner.run_mtm`` builds them at bucket ``f_max`` (B4 + B2
    with the MH catalogue; the repeat engine v2 on a repeat table), from
    its shuffled start (or ``state``); pivots half among repeat copies."""
    import torch
    from graal_tpu_torch.core import mtm
    from graal_tpu_torch.ops.mini_grid_cuda import MiniGridScorer
    from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid

    runner = sc["runner"]
    st = sc["shuf"] if state is None else state
    jump = runner.jump_table(MTM_DELTA, st.n_frags)
    engine = mtm._delta_mh_scorer(sc["table"], f_max, sc["sobs"], runner.w, st.rep,
                                  WindowObsGrid(), MiniGridScorer())
    copies = torch.nonzero(st.rep == 1).reshape(-1)
    every = torch.arange(st.n_frags, device=st.pos.device)
    pivots = torch.cat([copies.repeat(max(1, st.n_frags // len(copies))), every]) \
        if len(copies) else every
    return move_case(label, "delta", variant, st, jump, sc["params"], mtm._delta_score_set(engine),
                     runner.anchor_fn()(st, sc["params"]), pivots, corrected=corrected)


def phase_move_kernels(device, sc, rsc, n_bins=384):
    """3e. The MTM / MH step kernels E1 (the neighbour set and its masks),
    E2 (the forward weights, the draw and g*) and E3 (the backward
    weights, the acceptance and the commit) against their plain versions
    on MOVE_DRAWS random draws at every refinement path's shape (the dense
    flagship's MTM, MH and corrected MTM, a circular contig at the pivot,
    the dense repeat twin on B3, the 100k delta MTM at f_max F_MAX and its
    corrected twin, the 20k repeat delta MH), each timed against its plain
    version. The CLI's level-1 shape is checked in phase 10a, the
    16,384 bucket in --top-tiers."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    print(f"MTM / MH step kernels E1 (set), E2 (draw), E3 (accept) vs plain, {MOVE_DRAWS} draws "
          f"a shape on {MOVE_PIVOTS} pivots; slots and acceptances equal outside "
          f"{MOVE_ULPS} ulps")
    cases = dense_move_cases(device, n_bins) + [
        delta_move_case("delta_100k_mtm", sc, "mtm", F_MAX),
        delta_move_case("delta_100k_mtm_corrected", sc, "mtm", F_MAX, corrected=True),
        delta_move_case("delta_repeat_20k_mh", rsc, "mh", F_MAX)]
    out = {case["label"]: move_shape(case, gen) for case in cases}
    accepted = sum(r["stats"]["accepted"] for r in out.values())
    compared = sum(r["stats"]["compared"] for r in out.values())
    check(0 < accepted < compared, f"E3: {accepted} of {compared} compared draws accepted")
    return out


def phase_move_top(sc):
    """(``--top-tiers``) E1-E3 at 11h's run_mtm shape: the 100k truth at
    bucket 16,384 (M = 7), against their plain versions and timed."""
    import torch

    gen = torch.Generator(device=sc["truth"].pos.device).manual_seed(SEED + 51)
    return move_shape(delta_move_case(f"delta_{TOP_TIERS[1]}_mtm", sc, "mtm", TOP_TIERS[1],
                                      state=sc["truth"]), gen)


def corr_wrapper():
    """The copy-correction kernels' wrapper (F1 and F2, launches keyed
    "frozen" / "sums")."""
    from graal_tpu_torch.ops.repeat_corr_cuda import CORR

    return CORR


def corr_launches():
    return dict(corr_wrapper().launches.by_key())


def want_corr_launches(path, got, calls):
    """One F1 and one F2 launch a scoring call of a repeat path (``calls``
    of them); the count goes to the kernels line under ``path``."""
    want = {"frozen": calls, "sums": calls}
    print(f"  copy-correction launches: {got} (one F1 + F2 pair a scoring call: {calls})")
    check(got == want, f"{path}: F1 / F2 launches {got} != {want}")
    CORR_PATHS[path] = got


def corr_case(label, sc, f_max, chains=0, mh=False, state=None):
    """A shape of phase 3f: the repeat engine v2 of ``sc`` at bucket
    ``f_max`` as its path builds it (the EM catalogue, or the MH one with
    E1's neighbour set from the runner's jump table), on ``chains`` chains
    from distinct shuffles with their own parameters, or on one genome (the
    shuffled start, or ``state``). ``draw(gen)`` draws a scoring call's
    (f_a (C,), neighbours (C, m)): f_a half among repeat copies and
    originals of duplicated bins, the neighbours as the path draws them."""
    import torch
    from graal_tpu_torch.core import delta_repeats, mcmc, mtm
    from graal_tpu_torch.core.state import GenomeState

    runner = sc["runner"]
    st = sc["shuf"] if state is None else state
    device = st.pos.device
    if chains:
        states, params = chain_starts(sc, chains), chain_params(sc["params"], chains)
    else:
        states, params = GenomeState(*[x[None] for x in st]), sc["params"]
    engine = delta_repeats.make_repeat_delta_scorer_v2(
        sc["table"], f_max, sc["sobs"], st.rep, catalogue=mtm.mh_candidates if mh else None)
    rep = torch.nonzero(st.rep == 1).reshape(-1)
    every = torch.arange(st.n_frags, device=device)
    pivots = torch.cat([rep.repeat(max(1, st.n_frags // len(rep))), every])
    jump = runner.jump_table(MTM_DELTA, st.n_frags) if mh else None
    c = states.pos.shape[0]

    def draw(gen):
        f_a = pivots[torch.randint(len(pivots), (c,), generator=gen, device=device)]
        if mh:
            ids = mtm.move_set(GenomeState(*[x[0] for x in states]), f_a[0], jump, f_a[0])[0]
            return f_a, ids[None]
        u = mcmc.draw_step_inputs(gen, runner.nb, DELTA, (c,)).u_nb
        return f_a, mcmc.sample_neighbours(u, f_a, states, runner.nb, DELTA)[0].long()

    return dict(label=label, engine=engine, states=states, params=params, draw=draw,
                f_max=engine.f_max, chains=c, mh=mh)


def corr_args(case, f_a, ids):
    """A scoring call's arguments of F1 / F2 (and of the plain version), as
    the engine's ``score`` builds them: (state, f_a, rows, valid, geo,
    accu_sub, pvec, dll1), B2's deltas from the engine's own B2."""
    from graal_tpu_torch.core.delta import extract_rows_each, geometry_of

    engine, states = case["engine"], case["states"]
    p = engine.plain
    rows, valid, _ = extract_rows_each(states, f_a, ids, engine.f_max)
    _, vec, ob, pvec = p.inputs(states, f_a, ids, rows, valid, case["params"],
                                states.id_c.amax(-1))
    _, dll1 = p.mini_grid(*p.mini_grid_args(vec, ob, pvec))
    return states, f_a, rows, valid, geometry_of(vec), vec.accu_sub, pvec, dll1


def check_corr_kernels(case, gen, n_draws=CORR_DRAWS):
    """F1 / F2 against the plain version on ~``n_draws`` random (f_a,
    neighbour) slots of one shape: corr and cross within rtol CORR_RTOL
    (atol CORR_ATOL), dll within max(DLL_ATOL, one f32 ulp); the largest
    differences kept on the card and read once. Returns (stats, the last
    call's arguments)."""
    import torch

    engine = case["engine"]
    corr = corr_wrapper()
    zero = torch.zeros((), dtype=torch.float64, device=case["states"].pos.device)
    worst = dict(corr_rel=zero.clone(), cross_rel=zero.clone(), dll_abs=zero.clone(),
                 dll_ulps=zero.clone())
    bad = torch.zeros((), dtype=torch.int64, device=zero.device)
    most_valid = torch.zeros((), dtype=torch.int64, device=zero.device)
    n_calls = 0
    slots = 0
    while slots < n_draws:
        args = corr_args(case, *case["draw"](gen))
        most_valid = torch.maximum(most_valid, args[3].sum(-1).amax())
        got = corr.corrections(engine.corr_tables, *args)
        want = engine.corrections_plain(*args)
        for name, k, p in (("corr_rel", got[0], want[0]), ("cross_rel", got[1], want[1])):
            diff = (k - p).abs()
            worst[name] = torch.maximum(worst[name],
                                        (diff / p.abs().clamp_min(1e-300)).amax())
            bad += (diff > CORR_RTOL * p.abs() + CORR_ATOL).sum()
        d = (got[2].double() - want[2].double()).abs()
        ulp = (torch.nextafter(want[2].abs(), torch.tensor(float("inf"), device=d.device))
               - want[2].abs()).double()
        worst["dll_abs"] = torch.maximum(worst["dll_abs"], d.amax())
        worst["dll_ulps"] = torch.maximum(worst["dll_ulps"], (d / ulp).amax())
        bad += (d > torch.clamp_min(ulp, DLL_ATOL)).sum()
        bad += (~torch.isfinite(got[2])).sum() + (~torch.isfinite(got[0])).sum()
        n_calls += 1
        slots += args[2].shape[0] * args[2].shape[1]
    stats = {k: v.item() for k, v in worst.items()}
    stats.update(calls=n_calls, slots=slots, beyond_tolerance=int(bad),
                 most_valid=int(most_valid))
    return stats, args


def corr_bound(case, args, scratch):
    """The least time of F1 and of F2 on one call (:func:`bound`), counting
    what this call's data needs: F1 reads each slot's rows, the table
    entries of its D rows, the mixed windows and data-grid rows it routes
    and the frozen state of the copy rows it reads (and, once a chain, the
    K copy rows' activity and accu), writes its records, and evaluates the
    frozen copy pairs of the multi-multi entries and of part 4; F2 reads
    every row's activity and accu, the rest of the geometry at the rows
    the records name, F1's records and their observed entries, writes
    corr, cross and dll, and evaluates 14 genomes' in-D copy pairs and log
    terms. A copy pair is 20 FP32 and 2 special-function
    operations (a log and an exp), a log term 3 FP32 and 1; an f64
    operation counts as two FP32 ones."""
    import torch

    t = case["engine"].corr_tables
    states, f_a, rows, valid, geo, accu_sub, pvec, dll1 = args
    big_m, r = geo.mid.shape[0], geo.mid.shape[2]
    c = t.c_max
    n_rec = scratch["n_rec"].long()
    filled = torch.arange(scratch["mx_rec"].shape[1], device=n_rec.device) < n_rec[:, :1]
    n_mx = int(n_rec[:, 0].sum())
    mx_pairs = int(((scratch["mx_rec"][..., 2:] >= 0) & filled[..., None]).sum())
    mx_frozen = int(((scratch["mx_rec"][..., 2:] < 0) & filled[..., None]).sum())
    dd = scratch["dd_mini"]
    dd_in_pairs = int(((dd[:, :, 0] >= 0).sum(-1) * (dd[:, :, 1] >= 0).sum(-1)).sum())
    dd_out_pairs = int(((t.ddu_ok & (dd[:, :, 0] < 0)).sum(-1)
                        * (t.ddv_ok & (dd[:, :, 1] < 0)).sum(-1)).sum()) if dd.numel() else 0
    n_p4 = int((scratch["p4_ent"] >= 0).sum())
    p4_pairs = n_p4 * c
    n_sb = int(n_rec[:, 1].sum())
    ndd = t.dd_ob.shape[0]
    # the scratch F1 writes and F2 reads: the records in use, not their room
    scratch_bytes = (big_m * 8 + n_mx * ((2 + c) * 4 + 4) + n_sb * 8 + big_m * r * 4
                     + big_m * ndd * (12 + 8 * c) + big_m * t.s_max * (t.capd * 12 + c * 4)
                     + states.pos.shape[0] * 8)
    frozen_rows = mx_frozen + big_m * r * c + dd_out_pairs + p4_pairs
    f1_bytes = (rows.numel() * 9 + big_m * r * (4 * 5 + 1 + 4 * c) + n_mx * (4 + 8 + 4 * c)
                + big_m * t.s_max * t.capd * 12 + frozen_rows * 6 * 4
                + states.pos.shape[0] * t.owner.shape[0] * 12 + scratch_bytes)
    f1_fp32 = (dd_out_pairs + p4_pairs) * 20 + states.pos.shape[0] * t.owner.shape[0] * 2
    f1_sfu = (dd_out_pairs + p4_pairs) * 2
    # F2 reads every row's activity and accu (the cross term) and the rest
    # of the geometry (mid, idc, circ, stot: 16 bytes a genome) at the rows
    # its records name
    named = torch.zeros((big_m, r), dtype=torch.bool, device=n_rec.device)
    slot_ix = torch.arange(big_m, device=n_rec.device)[:, None]
    rec = scratch["mx_rec"]
    for col in range(rec.shape[-1]):
        if col != 1:
            named[slot_ix, torch.where(filled, rec[..., col], -1).clamp_min(0)] |= \
                filled & (rec[..., col] >= 0)
    pairs_sb = torch.arange(scratch["sb_pair"].shape[1], device=n_rec.device) < n_rec[:, 1:]
    for col in range(2):
        named[slot_ix, scratch["sb_pair"][..., col].clamp(0, r - 1)] |= pairs_sb
    dd_rows = dd.reshape(big_m, -1)
    named[slot_ix, dd_rows.clamp_min(0)] |= dd_rows >= 0
    geo_bytes = big_m * N_GEN_ROWS * r + accu_sub.numel() * 4 \
        + int(named.sum()) * N_GEN_ROWS * 16
    f2_bytes = (geo_bytes + scratch_bytes + (n_mx + n_p4 + big_m * ndd) * 8
                + dll1.numel() * 4 + pvec.numel() * 4 + big_m * (14 * 8 + 13 * 8 + 13 * 4))
    pairs = 14 * (mx_pairs + dd_in_pairs + n_sb)
    terms = 14 * (n_mx + big_m * ndd + n_p4)
    f2_fp32 = pairs * 20 + terms * 3 + 2 * (terms + pairs) + 2 * 2 * 13 * big_m * r
    f2_sfu = pairs * 2 + terms
    counts = dict(mixed_records=n_mx, mixed_pairs=mx_pairs, dd_in_pairs=dd_in_pairs,
                  dd_frozen_pairs=dd_out_pairs, part4_records=n_p4, same_bin_pairs=n_sb)
    return (bound(f1_bytes, f1_fp32, f1_sfu), bound(f2_bytes, f2_fp32, f2_sfu), counts)


def time_corr_kernels(case, args):
    """F1 alone, F2 alone (each launched from one argument block, outside
    the wrapper's count) and the pair through the wrapper, event ms as
    called and device ms; the plain version's ms as called and on the
    device (as graph replays); each kernel's bound."""
    import ctypes

    import torch
    from graal_tpu_torch.ops import repeat_corr_cuda as rc

    engine = case["engine"]
    lib = rc.load_library()
    a, keep, _ = rc.call_args(engine.corr_tables, *args)
    counter = scratch_fields(a, ("frozen_counter", "sums_counter"))
    stream = torch.cuda.current_stream().cuda_stream

    def f1():
        check(lib.repeat_corr_frozen(ctypes.byref(a), stream) == 0, "F1 launch failed")

    def f2():
        check(lib.repeat_corr_sums(ctypes.byref(a), stream) == 0, "F2 launch failed")

    f1()
    f2()
    torch.cuda.synchronize()
    b1, b2, counts = corr_bound(case, args, next(x for x in keep if isinstance(x, dict)))
    plain = functools.partial(engine.corrections_plain, *args)
    plain_ms = cuda_ms(plain, 5, n_warm=1)
    plain_dev = graph_device_ms(plain, 20)
    out = {}
    for name, fn, b in (("frozen", f1, b1), ("sums", f2, b2)):
        t = timed(fn, CORR_TIME_ITERS)
        t.update(plain_ms=plain_ms, plain_device_ms=plain_dev)
        out[name] = with_share(t, b)
    out["sums"]["layout"] = rc.SUMS_PLANS[a.sums_plan]
    pair = timed(lambda: corr_wrapper().corrections(engine.corr_tables, *args), CORR_TIME_ITERS)
    del keep, counter
    return out, pair, counts


def corr_shape(case, gen, n_draws=CORR_DRAWS):
    """Phase 3f's check and timing of one shape; the record (kept in
    CORR_SHAPES under the shape's label) and its printed summary."""
    stats, args = check_corr_kernels(case, gen, n_draws)
    times, pair, counts = time_corr_kernels(case, args)
    big_m, r = args[4].mid.shape[0], args[4].mid.shape[2]
    c_max = case["engine"].corr_tables.c_max
    same = stats["corr_rel"] == stats["cross_rel"] == stats["dll_abs"] == 0
    print(f"  {case['label']}: M = {big_m} ({case['chains']} chain(s)), R = {r}, c_max {c_max}, "
          f"{stats['calls']} "
          f"calls, {stats['slots']} slots, valid rows up to {stats['most_valid']}; corr rel "
          f"{stats['corr_rel']:.3g}, cross rel "
          f"{stats['cross_rel']:.3g}, dll {stats['dll_abs']:.3g} ({stats['dll_ulps']:.2f} "
          f"ulps): "
          + ("bit-identical to the plain version's sums on these draws" if same else
             f"within rtol {CORR_RTOL} and one ulp, not bit-identical (F2's fixed f64 order, "
             "not torch's)")
          + f"; beyond tolerance {stats['beyond_tolerance']}; last call {json.dumps(counts)}")
    for k, (name, rec) in enumerate(times.items()):
        layout = f", layout {rec['layout']}" if "layout" in rec else ""
        print(f"    F{k + 1} {name}: {rec['device_ms']:.4f} device ms ({rec['ms']:.4f} as called); "
              f"{fmt_bound(rec)}{layout}")
    print(f"    pair through the wrapper {pair['device_ms']:.4f} device ms ({pair['ms']:.4f} as "
          f"called); plain {times['sums']['plain_device_ms']:.4f} device ms as graph replays "
          f"({times['sums']['plain_ms']:.4f} as called)")
    check(stats["beyond_tolerance"] == 0,
          f"{case['label']}: {stats['beyond_tolerance']} values of F1 / F2 beyond tolerance")
    rec = dict(stats=stats, kernels=times, pair=pair, counts=counts, M=big_m, R=r, c_max=c_max,
               chains=case["chains"], mh=case["mh"])
    CORR_SHAPES[case["label"]] = rec
    return rec


def phase_corr_kernels(device, rsc):
    """3f. The copy-correction kernels F1 (routing and frozen terms) and F2
    (the per-genome sums and the delta) against their plain version on
    CORR_DRAWS random (f_a, neighbour) slots at every repeat path's shape:
    the 20k repeat delta EM step (m = 10), 4 chains (M = 40), 3 chains at
    bucket 4,096 (M = 30), the 20k repeat delta MH step (M = 7), the
    12-dup exactness twin and the 20k problem with 2 to 12 copies a
    duplicated bin (MANY_COPIES), and the truth at bucket 8,192 (valid rows
    above 4,096, the large-R routing; ``--top-tiers`` times it again); each
    timed against the plain version. The launches F1 and F2 counted on the
    card equal the wrapper's calls counted on the host."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 60)
    print(f"copy-correction kernels F1 (frozen), F2 (sums) vs plain, ~{CORR_DRAWS} slots a "
          f"shape: corr / cross rtol {CORR_RTOL} (atol {CORR_ATOL}), dll max({DLL_ATOL}, 1 ulp)")
    cases = corr_cases(device, rsc)
    calls = {}
    reset_counted(corr_wrapper(), calls)
    from graal_tpu_torch.ops.repeat_corr_cuda import RepeatCorrKernels

    with counting_calls(calls, RepeatCorrKernels, "corrections", ("frozen", "sums")):
        out = {case["label"]: corr_shape(case, gen) for case in cases}
    big = out[f"repeat_20k_em_truth_{TOP_TIERS[0]}"]["stats"]["most_valid"]
    check(big > 4096, f"3f's large-R shape has {big} valid rows, not above 4,096")
    check_counted("3f", corr_wrapper(), {k: calls.get(k, 0) for k in ("frozen", "sums")})
    return out


def corr_cases(device, rsc):
    """Phase 3f's shapes (:func:`corr_case`), in order."""
    from graal_tpu_torch.entry import scale_repeat_problem
    from graal_tpu_torch.scale import ScaleRunner

    truth, shuf, table, params, sobs, id_d = scale_repeat_problem(EXACT_BINS, EXACT_REPEAT_DUPS,
                                                                  device=device)
    twin = dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs,
                runner=ScaleRunner(table, sobs, params, id_d=id_d))
    extra = [k % (MANY_COPIES - 1) + 1 for k in range(REPEAT_DUPS)]
    truth, shuf, table, params, sobs, id_d = scale_repeat_problem(
        EXACT_BINS, REPEAT_DUPS, copies=extra, device=device)
    many = dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs,
                runner=ScaleRunner(table, sobs, params, id_d=id_d))
    cases = [corr_case("repeat_20k_em", rsc, F_MAX),
             corr_case("repeat_20k_em_4_chains", rsc, F_MAX, chains=CHAINS),
             corr_case("repeat_20k_em_3_chains_4096", rsc, TOP_F_MAX, chains=3),
             corr_case("repeat_20k_mh", rsc, F_MAX, mh=True),
             corr_case("repeat_12dup_em", twin, F_MAX),
             corr_case(f"repeat_20k_em_{MANY_COPIES}_copies", many, F_MAX),
             corr_case(f"repeat_20k_em_truth_{TOP_TIERS[0]}", rsc, TOP_TIERS[0],
                       state=rsc["truth"])]
    return cases


def phase_corr_top(rsc):
    """(``--top-tiers``) F1 / F2 at R = 8,192: the 20k repeat truth (contigs
    of ~5,000 fragments) at bucket 8,192, one genome, m = 10."""
    import torch

    gen = torch.Generator(device=rsc["truth"].pos.device).manual_seed(SEED + 61)
    return corr_shape(corr_case(f"repeat_20k_em_{TOP_TIERS[0]}", rsc, TOP_TIERS[0],
                                state=rsc["truth"]), gen)


def corr_records():
    """The kernels line's entries of F1 (repeat_corr_frozen) and F2
    (repeat_corr_sums): the 20k repeat delta EM step's numbers, phase 3f's
    other shapes under "by_shape", and under "by_path" each repeat path's
    launches counted on the card (7b, 7g / 7h's repeat cycles, 8a, 11b,
    the CLI's repeat scale), whose sum is the top-level count;
    "max_abs_err" the largest dll difference from the plain version over
    every shape, "rel_err" each shape's corr / cross relative errors."""
    out = []
    flagship = CORR_SHAPES["repeat_20k_em"]
    err = max(r["stats"]["dll_abs"] for r in CORR_SHAPES.values())
    rel = {label: {k: r["stats"][k] for k in ("corr_rel", "cross_rel", "dll_ulps")}
           for label, r in CORR_SHAPES.items()}
    for kind, name, line in (("frozen", "repeat_corr_frozen", 590),
                             ("sums", "repeat_corr_sums", 748)):
        paths = {path: by_key[kind] for path, by_key in CORR_PATHS.items() if by_key.get(kind)}
        check(paths, f"no main path launched the {name} kernel")
        out.append(kernel_record(name, "repeat_corr.cu", f"graal_tpu/core/delta_repeats.py:{line}",
                                 sum(paths.values()), dict(
                                     flagship["kernels"][kind], max_abs_err=err, by_path=paths,
                                     by_shape={label: r["kernels"][kind]
                                               for label, r in CORR_SHAPES.items()
                                               if label != "repeat_20k_em"},
                                     rel_err=rel)))
    return out


def rows_wrapper():
    """The member-row kernels' wrapper (G1 / G2 / G3, launches keyed
    "counts" / "write" / "gather")."""
    from graal_tpu_torch.ops.rows_cuda import ROWS

    return ROWS


def rows_launches():
    """G1-G3's and I1 / I2's launches by key, read from the card."""
    return dict(rows_wrapper().launches.by_key()) | dict(inputs_wrapper().launches.by_key())


def row_set(calls):
    """The launches of ``calls`` delta scoring calls: one G1 + G2 pair, one
    G3, one I1 and one I2 each."""
    return {"counts": calls, "write": calls, "gather": calls, "delta_slots": calls,
            "delta_vectors": calls}


def want_rows_launches(path, got, calls):
    """One G1 + G2 pair, one G3, one I1 and one I2 launch a scoring call of
    a delta path (``calls`` of them); the count goes to the kernels line
    under ``path``."""
    want = row_set(calls)
    print(f"  member-row and input launches: {got} (one G1 + G2 pair, one G3, one I1 and one "
          f"I2 a scoring call: {calls})")
    check(got == want, f"{path}: G1-G3, I1 / I2 launches {got} != {want}")
    ROWS_PATHS[path] = got


def rows_paths(records, want_calls):
    """Keep each graphed delta path's G1-G3 and I1 / I2 launches (the graph
    run's, equal to the eager run's) for the kernels line, one set a
    scoring call (``want_calls[name]``)."""
    for name, calls in want_calls.items():
        got = [k for k in records[name]["graph"]["by_key"] if "write" in k]
        got = [got[0] | records[name]["graph"]["inputs"]] if len(got) == 1 else got
        check(got == [row_set(calls)],
              f"{name}: G1-G3, I1 / I2 launches {got} != one set a scoring call ({calls})")
        ROWS_PATHS[f"graph_{name}"] = got[0]


def rows_case(label, sc, f_max, states=None, union=True, mh=False, uniform_m=0):
    """A shape of phase 3g: member rows at bucket ``f_max`` as a path
    extracts them (``union``: the repeat-free delta EM step's; else each
    neighbour on its own, the repeat engine's and the delta MTM / MH
    steps') from ``states`` (fields (C, n); the set-up's shuffled start by
    default). ``draw(gen)`` draws a scoring call's (f_a (C,), neighbours
    (C, m)) as the path draws them (D2's draw from ``sc``'s runner; E1's
    neighbour set for MH), or ``uniform_m`` neighbours uniform over the
    genome; f_a half among repeat copies on a repeat genome; one call in
    eight puts fA itself among the neighbours, one in eight puts two slots
    on one contig."""
    import torch
    from graal_tpu_torch.core import mcmc, mtm
    from graal_tpu_torch.core.state import GenomeState

    runner = sc["runner"]
    if states is None:
        states = GenomeState(*[x[None] for x in sc["shuf"]])
    one = GenomeState(*[x[0] for x in states])
    n = one.n_frags
    device = one.pos.device
    rep = torch.nonzero(one.rep == 1).reshape(-1)
    every = torch.arange(n, device=device)
    pivots = torch.cat([rep.repeat(max(1, n // len(rep))), every]) if len(rep) else every
    jump = runner.jump_table(MTM_DELTA, n) if mh else None
    c = states.pos.shape[0]
    calls = [0]

    def draw(gen):
        f_a = pivots[torch.randint(len(pivots), (c,), generator=gen, device=device)]
        if uniform_m:
            ids = torch.randint(n, (c, uniform_m), generator=gen, device=device)
        elif mh:
            ids = mtm.move_set(one, f_a[0], jump, f_a[0])[0][None].long()
        else:
            u = mcmc.draw_step_inputs(gen, runner.nb, DELTA, (c,)).u_nb
            ids = mcmc.sample_neighbours(u, f_a, states, runner.nb, DELTA)[0].long()
        calls[0] += 1
        if calls[0] % 8 == 1:
            ids[:, 0] = f_a
        elif calls[0] % 8 == 5 and ids.shape[1] > 1:
            ids[:, 1] = ids[:, 0]
        return f_a, ids.contiguous()

    return dict(label=label, states=states, f_max=min(f_max, n), union=union, draw=draw,
                chains=c, n=n)


def rows_plain(case, f_a, ids):
    """The plain extraction of a shape's mode and the chains' maxima."""
    from graal_tpu_torch.core import delta

    fn = delta.extract_rows_union_plain if case["union"] else delta.extract_rows_each_plain
    states = case["states"]
    return (*fn(states, f_a, ids, case["f_max"]), states.id_c.amax(-1))


def check_rows_kernels(case, gen, n_draws=ROWS_DRAWS):
    """G1-G3 against their plain versions on ~``n_draws`` random (chain,
    slot) draws of one shape: rows (padding included), valid, overflow,
    max_id and the 11 mini-state fields bit for bit; the differences
    counted on the card and read once. Returns (stats, the last call's
    (f_a, ids))."""
    import torch
    from graal_tpu_torch.core import delta

    states, f_max = case["states"], case["f_max"]
    rows_k = rows_wrapper()
    dev = states.pos.device
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    over = torch.zeros((), dtype=torch.int64, device=dev)
    partial = torch.zeros((), dtype=torch.int64, device=dev)
    n_calls = slots = 0
    while slots < n_draws:
        f_a, ids = case["draw"](gen)
        got = rows_k.extract(states.id_c, f_a, ids, f_max, case["union"])
        want = rows_plain(case, f_a, ids)
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{case['label']}: {tuple(g.shape)} {g.dtype} != {tuple(w.shape)} {w.dtype}")
            bad += (g != w).sum()
        mini = rows_k.gather(states, got[0], got[1])
        plain = delta.gather_mini_plain(states, got[0], got[1])
        bad += (mini != torch.stack(list(plain))).sum()
        over += got[2].sum()
        partial += (got[1].sum(-1) < f_max).sum()
        n_calls += 1
        slots += ids.numel()
    stats = dict(calls=n_calls, slots=slots, overflowed=int(over), padded=int(partial),
                 differences=int(bad))
    return stats, (f_a, ids)


def rows_bound(case, out, chunk):
    """The least time of G1, G2 and G3 on one call (:func:`bound`, bytes):
    G1 reads the chains' id_c and writes its counts, sorted keys and chunk
    maxima; G2
    reads those and the id_c of the chunks that hold an output row, and
    writes rows (8 bytes), valid, overflow and max_id; G3 reads rows and
    valid and the 11 fields of each distinct (chain, row) it gathers, and
    writes the (11, C, m, f_max) int32 mini-states."""
    import torch

    rows, valid = out[0], out[1]
    c, m, f_max = rows.shape
    n = case["n"]
    n_chunks = -(-n // chunk)
    scratch = c * ((m + 1) * (n_chunks + 1) + n_chunks) * 4   # counts, sorted keys, maxima
    ch = torch.arange(c, device=rows.device)[:, None]
    chunks = int(torch.unique(ch * n_chunks + (rows.reshape(c, -1) // chunk)).numel())
    distinct = int(torch.unique(ch * n + rows.reshape(c, -1)).numel())
    g1 = c * n * 4 + c * (m + 1) * 8 + scratch
    g2 = scratch + chunks * chunk * 4 + c * (m + 1) * 8 + rows.numel() * 9 + c * m + c * 4
    g3 = rows.numel() * 9 + distinct * 11 * 4 + rows.numel() * 11 * 4
    return bound(g1), bound(g2), bound(g3), dict(chunks_read=chunks, distinct_rows=distinct)


def g1_plain(id_c, f_a, ids, chunk):
    """What G1 writes to its scratch, in plain torch: each contig's rows in
    a chunk at its first place in the chain's sorted keys (C, m + 1,
    n_chunks), each chunk's largest id (C, n_chunks), the sorted keys (C, m
    + 1); int32, as the wrapper allocates them."""
    import torch

    c, n = id_c.shape
    dev = id_c.device
    skeys = torch.cat([id_c.gather(1, f_a[:, None]), id_c.gather(1, ids)], 1).sort(1).values
    n_keys, n_chunks = skeys.shape[1], -(-n // chunk)
    place = torch.searchsorted(skeys, id_c.contiguous())   # the first place not below
    hit = (place < n_keys) & (skeys.gather(1, place.clamp(max=n_keys - 1)) == id_c)
    chunk_of = (torch.arange(n, device=dev) // chunk).expand(c, n)
    flat = (torch.arange(c, device=dev)[:, None] * n_keys + place) * n_chunks + chunk_of
    counts = torch.zeros(c * n_keys * n_chunks, dtype=torch.int64, device=dev)
    counts.index_add_(0, flat[hit], torch.ones_like(flat[hit]))
    cmax = torch.full((c, n_chunks), -2 ** 31, dtype=torch.int32, device=dev).scatter_reduce(
        1, chunk_of, id_c.contiguous(), "amax")
    return [counts.view(c, n_keys, n_chunks).int(), cmax, skeys]


def time_rows_kernels(case, f_a, ids):
    """G1, G2 and G3 alone (each launched from one argument block, outside
    the wrapper's count), event ms as called and device ms; the plain
    versions' ms as called and on the device (as graph replays: the
    extraction with the chains' maxima, and gather_mini_plain); torch.topk
    on the plain version's genome-length key alone, the library call
    (mode each: the (C, m, n) members-first key, k = f_max; union: the
    union's (C, n) key, k = min(n, (m + 1) f_max)); each kernel's bound."""
    import ctypes

    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.ops import rows_cuda as rc

    states, f_max, union = case["states"], case["f_max"], case["union"]
    lib = rc.load_library()
    a, keep, out = rc.extract_args(states.id_c, f_a, ids, f_max, union)
    counter = scratch_fields(a, ("counts_counter", "write_counter"))
    stream = torch.cuda.current_stream().cuda_stream

    def g1():
        check(lib.rows_counts(ctypes.byref(a), stream) == 0, "G1 launch failed")

    def g2():
        check(lib.rows_write(ctypes.byref(a), stream) == 0, "G2 launch failed")

    g1()
    g2()
    torch.cuda.synchronize()
    g1_diffs = int(bit_diffs(list(keep[3]), g1_plain(states.id_c, f_a, ids, a.chunk)))
    check(g1_diffs == 0, f"{case['label']}: {g1_diffs} values of G1's scratch (counts, chunk "
          "maxima, sorted keys) differ from its plain count")
    g, keep_g, _ = rc.gather_args(states, out[0], out[1])
    counter_g = scratch_fields(g, ("counter",))

    def g3():
        check(lib.rows_gather(ctypes.byref(g), stream) == 0, "G3 launch failed")

    b1, b2, b3, counts = rows_bound(case, out, a.chunk)
    plain_x = functools.partial(rows_plain, case, f_a, ids)
    plain_g = functools.partial(delta.gather_mini_plain, states, out[0], out[1])
    n, m = case["n"], ids.shape[1]
    id_c = states.id_c
    c_a = id_c.gather(1, f_a[:, None])
    c_b = id_c.gather(1, ids)
    if union:
        memb = (id_c[:, :, None] == torch.cat([c_a, c_b], 1)[:, None, :])
        fits = memb.sum(1, keepdim=True) <= f_max
        key = delta._member_key((memb & fits).any(-1), n)
        k = min(n, (m + 1) * f_max)
    else:
        member = (id_c[:, None, :] == c_a[:, :, None]) | (id_c[:, None, :] == c_b[:, :, None])
        key, k = delta._member_key(member, n), f_max
    library = timed(lambda: torch.topk(key, k, dim=-1, sorted=True), ROWS_TIME_ITERS)
    rec = {}
    for name, fn, b, plain in (("counts", g1, b1, plain_x), ("write", g2, b2, plain_x),
                               ("gather", g3, b3, plain_g)):
        t = timed(fn, ROWS_TIME_ITERS)
        t.update(plain_ms=cuda_ms(plain, 5, n_warm=1), plain_device_ms=graph_device_ms(plain, 20),
                 library_ms=library["ms"] if name == "write" else None,
                 library_device_ms=library["device_ms"] if name == "write" else None)
        rec[name] = with_share(t, b)
    pair = timed(lambda: rows_wrapper().extract(states.id_c, f_a, ids, f_max, union),
                 ROWS_TIME_ITERS)
    del keep, keep_g, counter, counter_g
    return rec, pair, library, dict(counts, chunk=a.chunk, n_chunks=a.n_chunks, k=k)


def rows_shape(case, gen, n_draws=ROWS_DRAWS):
    """Phase 3g's check and timing of one shape; the record (kept in
    ROWS_SHAPES under the shape's label) and its printed summary."""
    stats, (f_a, ids) = check_rows_kernels(case, gen, n_draws)
    times, pair, library, counts = time_rows_kernels(case, f_a, ids)
    c, m = ids.shape
    mode = "union" if case["union"] else "each"
    print(f"  {case['label']}: {mode}, n = {case['n']}, C = {c}, m = {m} (M = {c * m}), f_max "
          f"{case['f_max']}; {stats['calls']} calls, {stats['slots']} slots, overflowed "
          f"{stats['overflowed']}, padded {stats['padded']}; differences "
          f"{stats['differences']}; last call {json.dumps(counts)}")
    for k, (name, rec) in enumerate(times.items()):
        print(f"    G{k + 1} {name}: {rec['device_ms']:.4f} device ms ({rec['ms']:.4f} as called); "
              f"{fmt_bound(rec)}; plain {rec['plain_device_ms']:.4f} device ms as graph "
              f"replays ({rec['plain_ms']:.4f} as called)")
    print(f"    G1 + G2 through the wrapper {pair['device_ms']:.4f} device ms ({pair['ms']:.4f} "
          f"as called); torch.topk on the plain version's key alone (k = {counts['k']}) "
          f"{library['device_ms']:.4f} device ms ({library['ms']:.4f} as called)")
    check(stats["differences"] == 0,
          f"{case['label']}: {stats['differences']} values of G1-G3 differ from plain")
    rec = dict(stats=stats, kernels=times, pair=pair, library=library, counts=counts, M=c * m,
               f_max=case["f_max"], n=case["n"], chains=c, mode=mode)
    ROWS_SHAPES[case["label"]] = rec
    return rec


def phase_rows_kernels(device, sc, rsc):
    """3g. The member-row kernels G1 (counts), G2 (the ordered write) and
    G3 (the mini-state gather) against their plain versions on ROWS_DRAWS
    random (chain, slot) draws at every delta path's shape: the 100k delta
    EM step (union, M = 5, f_max F_MAX), its 4 chains (M = 20), the 100k
    delta MTM pass (each, m = 7), the 20k repeat step (each, M = 10) and 4
    repeat chains (M = 40); the edge shapes: the 100k truth (contigs of
    5,000 above f_max: every pair overflows), f_max = n on a 2,000-fragment
    cut of the repeat problem's genome, and u_cap = n (the 20k repeat
    genome in union mode at bucket 4,096, (m + 1) f_max > n), and the
    repeat delta EM step at m = 80 (2 to ROW_COPIES copies a duplicated
    bin: more keys than 64), which is then driven on the card
    (:func:`rows_many_copies_steps`), and at m = 320 (2 to SLOT_COPIES
    copies, the slots drawn as D2 draws them); each shape timed against
    the plain versions and torch.topk. The launches G1-G3 counted on the
    card equal the wrapper's calls counted on the host."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 70)
    print(f"member-row kernels G1 (counts), G2 (write), G3 (gather) vs plain, ~{ROWS_DRAWS} "
          "slots a shape, every output bit for bit")
    cases = rows_cases(device, sc, rsc)
    calls = {}
    reset_counted(rows_wrapper(), calls)
    from graal_tpu_torch.ops.rows_cuda import RowKernels

    with counting_calls(calls, RowKernels, "extract", ("counts", "write")), \
            counting_calls(calls, RowKernels, "gather", ("gather",)):
        out = {case["label"]: rows_shape(case, gen) for case in cases}
    check_counted("3g", rows_wrapper(),
                  {k: calls.get(k, 0) for k in ("counts", "write", "gather")})
    rows_many_copies_steps(SETUPS["many_copies"])
    return out


def rows_cases(device, sc, rsc):
    """Phase 3g's shapes (:func:`rows_case`), in order; the m = 80 set-up
    kept in SETUPS["many_copies"]."""
    from graal_tpu_torch.core.state import GenomeState

    cut = GenomeState(*[x[None, :EDGE_N] for x in rsc["shuf"]])
    cases = [rows_case("delta_100k_em", sc, F_MAX),
             rows_case("delta_100k_em_4_chains", sc, F_MAX, states=chain_starts(sc)),
             rows_case("delta_100k_mtm", sc, F_MAX, union=False, mh=True),
             rows_case("repeat_20k_em", rsc, F_MAX, union=False),
             rows_case("repeat_20k_em_4_chains", rsc, F_MAX, states=chain_starts(rsc),
                       union=False),
             rows_case("delta_100k_truth", sc, F_MAX,
                       states=GenomeState(*[x[None] for x in sc["truth"]])),
             rows_case(f"f_max_n_{EDGE_N}", rsc, EDGE_N, states=cut, union=False, uniform_m=5),
             rows_case(f"f_max_n_{EDGE_N}_union", rsc, EDGE_N, states=cut, uniform_m=5),
             rows_case(f"u_cap_n_20k_{TOP_F_MAX}", rsc, TOP_F_MAX)]
    many = SETUPS["many_copies"] = many_copies_setup(device, ROW_COPIES)
    cases.append(rows_case(f"repeat_20k_em_{ROW_COPIES}_copies", many, F_MAX, union=False))
    slots = many_copies_setup(device, SLOT_COPIES)
    cases.append(rows_case(f"repeat_20k_em_{SLOT_COPIES}_copies", slots, F_MAX, union=False))
    return cases


def many_copies_setup(device, most):
    """The 20k repeat problem with 2 to ``most`` copies of each duplicated
    bin, its runner, and the repeat delta EM step's slot count m = (DELTA
    + 1) x most."""
    from graal_tpu_torch.entry import scale_repeat_problem
    from graal_tpu_torch.scale import ScaleRunner

    extra = [k % (most - 1) + 1 for k in range(REPEAT_DUPS)]
    truth, shuf, table, params, sobs, id_d = scale_repeat_problem(
        EXACT_BINS, REPEAT_DUPS, copies=extra, device=device)
    runner = ScaleRunner(table, sobs, params, id_d=id_d)
    m = (DELTA + 1) * runner.nb.max_copies
    check(runner.nb.max_copies == most and m >= 65,
          f"{most} copies a bin: max_copies {runner.nb.max_copies}, m = {m}")
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs, runner=runner,
                n=truth.n_frags, m=m)


def rows_many_copies_steps(mc):
    """3g: the repeat delta EM step at m >= 65 neighbour slots on the card
    (the many-copy problem): the repeat exactness twin's steps (4 repeat
    copies, 3 originals, 3 contig extremities), each re-anchored (the
    carried likelihood within max(0.5, 1e-6 |L|)), with one G1 + G2 pair
    and one G3 launch a step and one F1 + F2 pair."""
    import numpy as np
    import torch
    from graal_tpu_torch.core import delta

    runner, truth, shuf = mc["runner"], mc["truth"], mc["shuf"]
    step = delta.make_delta_em_step(mc["table"], None, runner.nb, DELTA, F_MAX, sobs=mc["sobs"],
                                    rep=truth.rep)
    rep = truth.rep.cpu().numpy()
    rng = np.random.default_rng(SEED + 72)
    copies = np.arange(EXACT_BINS, truth.n_frags)
    originals = np.nonzero(rep[:EXACT_BINS] == 1)[0]
    order = np.concatenate([rng.permutation(copies)[:4], rng.permutation(originals)[:3],
                            rng.permutation(extremities(shuf))[:3]])
    torch.cuda.synchronize()
    rows_wrapper().n_launches = inputs_wrapper().n_launches = corr_wrapper().n_launches = 0
    exactness_steps(f"repeat delta EM at m = {mc['m']} ({ROW_COPIES} copies a bin)", step,
                    runner.anchor_fn(), shuf, mc["params"], order, rep=rep)
    torch.cuda.synchronize()
    path = f"repeat_em_{ROW_COPIES}_copies"
    want_rows_launches(path, rows_launches(), len(order))
    want_corr_launches(path, corr_launches(), len(order))


def phase_rows_top(sc):
    """(``--top-tiers``) G1-G3 at f_max 16,384: 4 chains from the truth
    (M = 20), union mode as the chains' delta EM step extracts them."""
    import torch
    from graal_tpu_torch.core.state import GenomeState

    gen = torch.Generator(device=sc["truth"].pos.device).manual_seed(SEED + 71)
    states = GenomeState(*[x.expand(CHAINS, -1).contiguous() for x in sc["truth"]])
    return rows_shape(rows_case(f"delta_100k_4_chains_{TOP_TIERS[1]}", sc, TOP_TIERS[1],
                                states=states), gen)


def rows_records():
    """The kernels line's entries of G1 (rows_counts), G2 (rows_write) and
    G3 (rows_gather): the 100k delta EM step's numbers, phase 3g's other
    shapes under "by_shape", and under "by_path" each delta path's
    launches counted on the card, whose sum is the top-level count;
    "max_abs_err" 0 (every output bit for bit; a difference fails 3g);
    G2's "library_ms" torch.topk's on the plain version's key."""
    out = []
    flagship = ROWS_SHAPES["delta_100k_em"]
    for kind, name, line in (("counts", "rows_counts", 100), ("write", "rows_write", 121),
                             ("gather", "rows_gather", 179)):
        paths = {path: by_key[kind] for path, by_key in ROWS_PATHS.items() if by_key.get(kind)}
        check(paths, f"no main path launched the {name} kernel")
        rec = dict(flagship["kernels"][kind], max_abs_err=0, by_path=paths,
                   by_shape={label: r["kernels"][kind] for label, r in ROWS_SHAPES.items()
                             if label != "delta_100k_em"})
        library = rec.pop("library_ms")
        entry = kernel_record(name, "rows.cu", f"graal_tpu/core/delta.py:{line}",
                              sum(paths.values()), rec)
        entry["library_ms"] = library
        out.append(entry)
    return out


def inputs_wrapper():
    """The delta engine's input kernels' wrapper (I1 / I2, launches keyed
    "delta_slots" / "delta_vectors")."""
    from graal_tpu_torch.ops.delta_inputs_cuda import INPUTS

    return INPUTS


def inputs_scorer(sc, f_max, mh=False):
    """A delta scorer of ``sc``'s problem at bucket ``f_max`` as the path
    builds it: the repeat engine's single-copy scorer (``key_of``, with
    I2's extras) on a repeat table, else the plain engine (the MH catalogue
    with ``mh``)."""
    from graal_tpu_torch.core import delta, delta_repeats
    from graal_tpu_torch.core.candidates import mh_candidates

    cat = mh_candidates if mh else None
    if sc["table"].has_repeats:
        return delta_repeats.make_repeat_delta_scorer_v2(sc["table"], f_max, sc["sobs"],
                                                         sc["truth"].rep, catalogue=cat).plain
    return delta.make_delta_scorer(sc["table"], None, f_max, sobs=sc["sobs"], catalogue=cat)


def inputs_call(case, scorer, params, f_a, ids):
    """One scoring call's arguments of I1 (rows, f_a, ids, max_id, params)
    and the member rows' validity, as the path makes them on the card (the
    extraction and the chains' maxima by G1 / G2)."""
    from graal_tpu_torch.core import delta

    rows, valid, _, max_id = delta.extract_rows_max(case["states"], f_a, ids, scorer.f_max,
                                                     case["union"])
    return (rows, f_a, ids, max_id, params, scorer.log_nfpb), valid


def inputs_full(case, scorer, slots, valid, lf):
    """The slots' 14 genomes as the path builds them from I1's (lf_a, lf_b,
    max_id): G3's mini-states and the catalogue (C1 / C2)."""
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.core.state import GenomeState

    rows = slots[0]
    c, m, f_max = rows.shape
    mini = delta.gather_mini(case["states"], rows, valid)
    mini = GenomeState(*[x.reshape(c * m, f_max) for x in mini])
    return scorer.catalogue(mini, lf[0], lf[1], max_id=lf[2], with_base=True)


def check_inputs_kernels(case, scorer, params, gen, n_draws=INPUTS_DRAWS):
    """I1 and I2 against their plain versions on ~``n_draws`` random (chain,
    slot) draws of one shape, every output byte (bools as bytes); the
    differences counted on the card and read once. Returns (stats, the last
    call's (slot arguments, valid, 14 genomes))."""
    import torch
    from graal_tpu_torch.core import delta

    ik = inputs_wrapper()
    dev = case["states"].pos.device
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    absent = torch.zeros((), dtype=torch.int64, device=dev)
    live = torch.zeros((), dtype=torch.int64, device=dev)
    n_calls = slots = 0
    while slots < n_draws:
        f_a, ids = case["draw"](gen)
        args, valid = inputs_call(case, scorer, params, f_a, ids)
        got = ik.slots(*args)
        bad += bit_diffs(got, delta.slot_inputs_plain(*args))
        full = inputs_full(case, scorer, args, valid, got)
        vec = ik.vectors(full, args[0], valid, scorer.vt, scorer.extras)
        want = delta.sub_vectors_plain(full, args[0], valid, scorer.vt, scorer.extras)
        check(all((g is None) == (w is None) for g, w in zip(vec, want)),
              f"{case['label']}: I2's outputs {[g is None for g in vec]} != plain's")
        bad += bit_diffs([g for g in vec if g is not None], [w for w in want if w is not None])
        absent += (~(args[0] == ids[..., None]).any(-1)).sum()
        live += (vec.keys >= 0).sum()
        n_calls += 1
        slots += ids.numel()
    stats = dict(calls=n_calls, slots=slots, neighbours_absent=int(absent),
                 live_sub_rows=int(live), differences=int(bad))
    return stats, (args, valid, full)


def inputs_bound(args, valid, scorer, lf, vec):
    """The least time of I1 and of I2 on one call (:func:`bound`): I1 reads
    each slot's rows up to the later of its two first matches (all f_max
    where one is absent), fA, the neighbours, max_id and the parameters,
    and writes lf_a, lf_b, max_id and the 10-float rows; its 4 logs and a
    pow a slot are special-function work. I2 reads the rows and their
    validity, the mini table at the distinct rows, the 6 fields of the 14
    genomes, the sub-row tables at the distinct sub rows (key_of too on the
    repeat engine), and writes its planes (and extras); a log a live entry
    (bytes bound it)."""
    import torch

    rows, f_a, ids, max_id = args[:4]
    c, m, f_max = rows.shape
    big_m = c * m
    found = (rows == f_a[:, None, None]).any(-1) & (rows == ids[..., None]).any(-1)
    scanned = torch.where(found.reshape(-1), torch.maximum(lf[0], lf[1]) + 1, f_max)
    i1 = 8 * int(scanned.sum()) + c * (2 * f_a.element_size() + 8 * 4) \
        + ids.numel() * ids.element_size() + big_m * (16 + max_id.element_size() + 40)
    vt = scorer.vt
    subs, _ = scorer.sub_rows(rows.reshape(big_m, f_max), valid.reshape(big_m, f_max))
    distinct_subs = int(torch.unique(subs.clamp(0, scorer.k_subs - 1)).numel())
    distinct_rows = int(torch.unique(rows).numel())
    r = vec.mid.shape[-1]
    per_sub = 16 + (8 if vt.key_of is not None else 0)
    extras = vec.act is not None
    i2 = big_m * f_max * 9 + distinct_rows * 16 + 6 * 4 * big_m * 14 * f_max \
        + distinct_subs * per_sub + big_m * 14 * r * (20 + (5 if extras else 0)) \
        + big_m * r * (4 + (4 if extras else 0))
    live = int((vec.la > -1e9).sum())
    return bound(i1, sfu_ops=5 * big_m), bound(i2, fp32_ops=4 * big_m * 14 * r, sfu_ops=live)


def time_inputs_kernels(scorer, args, valid, full):
    """I1 and I2 alone (each launched from one argument block, outside the
    wrapper's count), event ms as called and device ms behind a spin kernel;
    the plain versions' ms as called and on the device as graph replays;
    each kernel's bound."""
    import ctypes

    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.ops import delta_inputs_cuda as di

    lib = di.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    a1, keep1, lf = di.slot_args(*args)
    a2, keep2, vec = di.vector_args(full, args[0], valid, scorer.vt, scorer.extras)
    counter = [scratch_fields(a, ("counter",)) for a in (a1, a2)]

    def i1():
        check(lib.delta_slots(ctypes.byref(a1), stream) == 0, "I1 launch failed")

    def i2():
        check(lib.delta_vectors(ctypes.byref(a2), stream) == 0, "I2 launch failed")

    i1()
    i2()
    torch.cuda.synchronize()
    b1, b2 = inputs_bound(args, valid, scorer, lf, vec)
    rec = {}
    for kind, fn, b, plain in (
            ("delta_slots", i1, b1, lambda: delta.slot_inputs_plain(*args)),
            ("delta_vectors", i2, b2, lambda: delta.sub_vectors_plain(
                full, args[0], valid, scorer.vt, scorer.extras))):
        t = timed(fn, INPUTS_TIME_ITERS)
        t.update(plain_ms=cuda_ms(plain, 5, n_warm=1), plain_device_ms=graph_device_ms(plain, 20),
                 library_ms=None)
        rec[kind] = with_share(t, b)
    del keep1, keep2, counter
    return rec


def inputs_shape(case, scorer, params, gen, n_draws=INPUTS_DRAWS):
    """Phase 3i's check and timing of one shape; the record (kept in
    INPUTS_SHAPES under the shape's label) and its printed summary."""
    stats, (args, valid, full) = check_inputs_kernels(case, scorer, params, gen, n_draws)
    times = time_inputs_kernels(scorer, args, valid, full)
    c, m, f_max = args[0].shape
    r = f_max * scorer.s_max
    engine = "repeat (key_of, extras)" if scorer.vt.key_of is not None else \
        ("plain, MH catalogue" if scorer.catalogue.__name__ == "mh_candidates" else "plain")
    print(f"  {case['label']}: {engine}, {'union' if case['union'] else 'each'}, n = "
          f"{case['n']}, C = {c}, m = {m} (M = {c * m}), f_max {f_max}, R = {r}; "
          f"{stats['calls']} calls, {stats['slots']} slots, neighbours absent from their rows "
          f"{stats['neighbours_absent']}, live sub rows {stats['live_sub_rows']}; differences "
          f"{stats['differences']}")
    for k, (kind, rec) in enumerate(times.items()):
        print(f"    I{k + 1} {kind}: {rec['device_ms']:.4f} device ms ({rec['ms']:.4f} as "
              f"called); {fmt_bound(rec)}; plain {rec['plain_device_ms']:.4f} device ms as graph "
              f"replays ({rec['plain_ms']:.4f} as called)")
    check(stats["differences"] == 0,
          f"{case['label']}: {stats['differences']} values of I1 / I2 differ from plain")
    check(stats["live_sub_rows"] > 0, f"{case['label']}: no live sub row in any call")
    rec = dict(stats=stats, kernels=times, M=c * m, f_max=f_max, R=r, n=case["n"], chains=c,
               mode="union" if case["union"] else "each", engine=engine)
    INPUTS_SHAPES[case["label"]] = rec
    return rec


def phase_inputs_kernels(device, sc, rsc):
    """3i. The delta engine's input kernels I1 (slot scalars and parameter
    rows) and I2 (sub-row vectors and window keys) against their plain
    versions on INPUTS_DRAWS random (chain, slot) draws at every delta
    path's shape: the 100k delta EM step (union, M = 5, f_max F_MAX), its 4
    chains with their own parameters (M = 20), the 100k delta MTM pass (M
    = 7, C2's catalogue), the 20k repeat step (M = 10, key_of) and 4 repeat
    chains (M = 40), and the repeat step at m = 80 on 2 to ROW_COPIES copies
    a bin (3g's problem); each shape timed against the plain versions.
    9d adds the CLI dataset's bucket, ``--top-tiers`` f_max 16,384."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 90)
    print(f"delta input kernels I1 (slots), I2 (vectors) vs plain, ~{INPUTS_DRAWS} slots a "
          "shape, every output byte")
    return inputs_counted("3i", lambda: {
        case["label"]: inputs_shape(case, scorer, params, gen)
        for case, scorer, params in inputs_cases(sc, rsc, SETUPS["many_copies"])})


def inputs_counted(label, run):
    """``run()``, the launches I1 and I2 counted themselves on the card held
    to the calls it made to them."""
    from graal_tpu_torch.ops.delta_inputs_cuda import DeltaInputKernels

    calls = {}
    reset_counted(inputs_wrapper(), calls)
    with counting_calls(calls, DeltaInputKernels, "slots", ("delta_slots",)), \
            counting_calls(calls, DeltaInputKernels, "vectors", ("delta_vectors",)):
        out = run()
    check_counted(label, inputs_wrapper(),
                  {k: calls.get(k, 0) for k in ("delta_slots", "delta_vectors")})
    return out


def inputs_cases(sc, rsc, many=None):
    """Phase 3i's shapes in order, each (case (:func:`rows_case`), scorer,
    params): the 100k delta EM step (union, M = 5), its 4 chains with their
    own parameters, the 100k delta MTM pass (M = 7, C2), the 20k repeat
    step (M = 10, key_of) and its 4 chains (M = 40), and, given ``many``
    (3g's problem of 2 to ROW_COPIES copies a bin), the repeat step at m =
    80."""
    shapes = [("delta_100k_em", sc, dict(), False, None),
              ("delta_100k_em_4_chains", sc, dict(states=chain_starts(sc)), False, CHAINS),
              ("delta_100k_mtm", sc, dict(union=False, mh=True), True, None),
              ("repeat_20k_em", rsc, dict(union=False), False, None),
              ("repeat_20k_em_4_chains", rsc, dict(states=chain_starts(rsc), union=False), False,
               CHAINS)]
    if many is not None:
        shapes.append((f"repeat_20k_em_{ROW_COPIES}_copies", many, dict(union=False), False,
                       None))
    out = []
    for label, s, kw, mh, chains in shapes:
        case = rows_case(label, s, F_MAX, **kw)
        params = chain_params(s["params"], chains) if chains else s["params"]
        out.append((case, inputs_scorer(s, case["f_max"], mh), params))
    return out


def inputs_top_case(sc):
    """``--top-tiers``' I1 / I2 shape, (case, scorer, params): 4 chains of
    the truth with their own parameters (M = 20) at f_max 16,384, union
    mode as the chains' delta EM step extracts them."""
    from graal_tpu_torch.core.state import GenomeState

    states = GenomeState(*[x.expand(CHAINS, -1).contiguous() for x in sc["truth"]])
    case = rows_case(f"delta_100k_4_chains_{TOP_TIERS[1]}", sc, TOP_TIERS[1], states=states)
    return case, inputs_scorer(sc, case["f_max"]), chain_params(sc["params"], CHAINS)


def phase_inputs_top(sc):
    """(``--top-tiers``) I1 and I2 at f_max 16,384 (:func:`inputs_top_case`),
    their launches counted on the card equal to the calls made."""
    import torch

    gen = torch.Generator(device=sc["truth"].pos.device).manual_seed(SEED + 91)
    return inputs_counted("3i top", lambda: inputs_shape(*inputs_top_case(sc), gen,
                                                         n_draws=INPUTS_TOP_DRAWS))


def inputs_records():
    """The kernels line's entries of I1 (delta_slots) and I2
    (delta_vectors): the 100k delta EM step's numbers, phase 3i's other
    shapes under "by_shape", and under "by_path" each delta path's
    launches counted on the card (beside G1-G3's, one of each a scoring
    call), whose sum is the top-level count; "max_abs_err" 0 (every output
    byte; a difference fails 3i); no single PyTorch call computes either
    function ("library_ms" null)."""
    out = []
    flagship = INPUTS_SHAPES["delta_100k_em"]
    for kind, line in (("delta_slots", 637), ("delta_vectors", 386)):
        paths = {path: by_key[kind] for path, by_key in ROWS_PATHS.items() if by_key.get(kind)}
        check(paths, f"no main path launched the {kind} kernel")
        rec = dict(flagship["kernels"][kind], max_abs_err=0, by_path=paths,
                   by_shape={label: r["kernels"][kind] for label, r in INPUTS_SHAPES.items()
                             if label != "delta_100k_em"})
        library = rec.pop("library_ms")
        entry = kernel_record(kind, "delta_inputs.cu", f"graal_tpu/core/delta.py:{line}",
                              sum(paths.values()), rec)
        entry["library_ms"] = library
        out.append(entry)
    return out


def vectors_wrapper():
    """The dense scorers' vector kernel's wrapper (H1, launches keyed
    "vectors")."""
    from graal_tpu_torch.ops.vectors_cuda import VECTORS

    return VECTORS


def scan_wrapper():
    """The captured cycle's load / store kernels' wrapper (H2 / H3,
    launches keyed "load" / "store")."""
    from graal_tpu_torch.ops.scan_cuda import SCAN

    return SCAN


def io_launches():
    """H1-H3's launches by key, read from the card."""
    return dict(vectors_wrapper().launches.by_key()) | dict(scan_wrapper().launches.by_key())


def io_want(steps, scorer_calls, calls):
    """H1-H3's launches by key on a path: one H3 a step of a captured cycle
    (its stores and the next step's loads), one H2 a call of a scan with
    per-step inputs (the call's first load), one H1 a dense scoring
    call."""
    return {"store": steps} | ({"load": calls} if calls else {}) \
        | ({"vectors": scorer_calls} if scorer_calls else {})


def want_io_launches(path, got, steps, scorer_calls, calls):
    """One H3 launch a step of a captured cycle (``steps``), one H2 launch
    a call (``calls``) and one H1 launch a dense scoring call
    (``scorer_calls``); the count goes to the kernels line under
    ``path``."""
    want = io_want(steps, scorer_calls, calls)
    print(f"  H1-H3 launches: {got} (one H3 a step: {steps}; one H2 a call: {calls}; one H1 "
          f"a dense scoring call: {scorer_calls})")
    check(got == want, f"{path}: H1-H3 launches {got} != {want}")
    IO_PATHS[path] = got


def bit_diffs(got, want):
    """Elements of ``got`` whose bits differ from ``want``'s (each pair of
    one shape and dtype), counted on the card."""
    import torch

    bad = torch.zeros((), dtype=torch.int64, device=got[0].device)
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{tuple(g.shape)} {g.dtype} != {tuple(w.shape)} {w.dtype}")
        u = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[g.element_size()]
        bad += (g.contiguous().view(u) != w.contiguous().view(u)).sum()
    return bad


def vectors_bound(scorer, batch, with_row):
    """H1's least time on one call (:func:`bound`, bytes): the fields it
    reads of each genome (every fragment owns a sub row), the table's
    vectors, the parameters, and the (B, K) planes and the row written."""
    b, n = batch.pos.shape
    with_a = scorer.accu_rows is not None
    n_fields = 6 if with_a else 5
    n_out = 5 if with_a else 4
    n_bytes = n_fields * b * n * 4 + scorer.k * 4 * (n_out) \
        + b * scorer.k * 4 * n_out + (10 * 4 + 9 * 4 if with_row else 0)
    return bound(n_bytes)


def scratch_counter():
    """An int64 on the card for launches made to time a self-counting
    kernel outside its wrapper, so they stay out of the wrapper's count."""
    import torch

    return torch.zeros((), dtype=torch.int64, device="cuda")


def scratch_fields(block, names):
    """Point the counter fields ``names`` of an argument block, where its
    struct has them, at one scratch counter (an earlier tree's block has
    none and counts nothing); returns the counter, to keep alive."""
    counter = scratch_counter()
    have = {name for name, _ in type(block)._fields_}
    for name in names:
        if name in have:
            setattr(block, name, counter.data_ptr())
    return counter


def counting_calls(calls, cls, method, keys):
    """A context in which every call of ``cls.method`` counts one launch of
    each of ``keys`` on the host into ``calls``, to hold the kernels' own
    counts to."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        orig = getattr(cls, method)

        def counted(self, *args, **kwargs):
            for key in keys:
                calls[key] = calls.get(key, 0) + 1
            return orig(self, *args, **kwargs)

        setattr(cls, method, counted)
        try:
            yield
        finally:
            setattr(cls, method, orig)
    return ctx()


def h1_args(batch, scorer, params):
    """H1's argument block of one scoring call, its launches counted on a
    scratch counter (a tree whose block has none counts nothing)."""
    from graal_tpu_torch.ops import vectors_cuda as vc

    a, keep, out = vc.vectors_args(batch, scorer.sub_rows, params, scorer.log_nfpb)
    if any(name == "counter" for name, _ in vc.VectorsArgs._fields_):
        counter = scratch_counter()
        a.counter = counter.data_ptr()
        keep = (keep, counter)
    return a, keep, out


def scan_scratch(tables):
    """``tables`` with their launches counted on a scratch counter (tables
    without one count nothing); returns what must stay alive."""
    counter = scratch_counter()
    for t in tables:
        if hasattr(t, "counter"):
            t.counter = counter.data_ptr()
    return counter


def counting_io_calls(calls):
    """A context in which every call made to H1's wrapper and every launch
    H2 / H3's wrapper makes (cut launches included) is counted on the host
    into ``calls`` by key, to hold the kernels' own counts to."""
    import contextlib

    from graal_tpu_torch.ops import scan_cuda, vectors_cuda

    @contextlib.contextmanager
    def ctx():
        vcall, launch = vectors_cuda.VectorKernels.__call__, scan_cuda.ScanKernels._launch

        def counted_call(self, *args, **kwargs):
            calls["vectors"] = calls.get("vectors", 0) + 1
            return vcall(self, *args, **kwargs)

        def counted_launch(self, kind, dev, t):
            calls[kind] = calls.get(kind, 0) + 1
            return launch(self, kind, dev, t)

        vectors_cuda.VectorKernels.__call__ = counted_call
        scan_cuda.ScanKernels._launch = counted_launch
        try:
            yield
        finally:
            vectors_cuda.VectorKernels.__call__ = vcall
            scan_cuda.ScanKernels._launch = launch
    return ctx()


def vectors_shape(label, scorer, batch, params):
    """Phase 3h's check and timing of H1 at one dense path's shape: the
    vectors (``a`` included on a repeat table) and the parameter row, bit
    for bit the plain versions (``vectors_plain``, ``params_vector``, torch
    on the card), on the batch and on its first genome as an ``x[None]``
    view (the nuisance call); then H1 alone from one argument block (event
    ms as called, device ms), the plain version's ms as called and as graph
    replays, and the bound."""
    import ctypes

    import torch
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.ops import vectors_cuda as vc
    from graal_tpu_torch.ops.likelihood_cuda import params_vector

    def plain():
        return scorer.vectors_plain(batch), params_vector(params, scorer.log_nfpb)

    vecs, row = scorer.vectors(batch, params)
    want, prow = plain()
    bad = bit_diffs(vecs + (row,), want + (prow,))
    one = GenomeState(*[x[0][None] for x in batch])
    bad += bit_diffs(scorer.vectors(one)[0], scorer.vectors_plain(one))
    a, keep, _ = h1_args(batch, scorer, params)
    lib = vc.load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def h1():
        check(lib.vectors(ctypes.byref(a), stream) == 0, "H1 launch failed")

    t = timed(h1, VEC_TIME_ITERS)
    t.update(plain_ms=cuda_ms(plain, 5, n_warm=1), plain_device_ms=graph_device_ms(plain, 20),
             library_ms=None)
    rec = with_share(t, vectors_bound(scorer, batch, True))
    b, n = batch.pos.shape
    differences = int(bad)
    del keep
    print(f"  {label}: B = {b}, n = {n}, K = {scorer.k}, vectors {', '.join(scorer.VECTORS)} + "
          f"row; differences {differences}; H1 {rec['device_ms']:.4f} device ms "
          f"({rec['ms']:.4f} as called); {fmt_bound(rec)}; plain {rec['plain_device_ms']:.4f} "
          f"device ms as graph replays ({rec['plain_ms']:.4f} as called)")
    check(differences == 0, f"{label}: {differences} values of H1 differ from plain")
    VEC_SHAPES[label] = dict(rec, B=b, n=n, K=scorer.k, differences=differences)
    return VEC_SHAPES[label]


def vectors_cases(device):
    """(label, scorer, batch, params) of every dense path's H1 shape: the
    flagship EM step (B = 65 and the nuisance call's B = 1, K = 1,152), the
    dense repeat step (B3, B = 130, and B = 1), 4 tempered chains (B =
    260), an MTM pass at K = 972 (B = 91, the CLI's level-2 width), the
    CLI's level-1 width K = 2,901 (B = 65) and K = 6,000 (B = 13)."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem, problem_jump_table, repeat_problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    gen = torch.Generator(device=device).manual_seed(SEED + 80)
    state, table, params, obs, nb = problem(n_bins=384, device=device)
    sc = make_dense_scorer(table, obs, device)
    start = mcmc.explode_genome(state)
    flag = candidate_batch(state, nb, 100, gen)
    check(flag.pos.shape[0] == 65, f"flagship batch {tuple(flag.pos.shape)}")
    chains = stack([candidate_batch(s, nb, f, gen) for s, f in
                    ((state, 7), (start, 200), (circularised(state), 0), (start, 383))])
    yield "dense_flagship_B65", sc, flag, params
    yield "dense_flagship_B1", sc, GenomeState(*[x[None] for x in start]), params
    yield "tempered_B260", sc, chains, params
    rstate, rtable, rparams, robs, rnb = repeat_problem(n_bins=384, device=device)
    rsc = make_dense_scorer(rtable, robs, device)
    rep = torch.nonzero(rstate.rep == 1).reshape(-1)
    rbatch = candidate_batch(rstate, rnb, int(rep[0]), gen)
    check(rbatch.pos.shape[0] == 130, f"repeat batch {tuple(rbatch.pos.shape)}")
    yield "dense_repeat_B130", rsc, rbatch, rparams
    yield "dense_repeat_B1", rsc, GenomeState(*[x[None] for x in mcmc.explode_genome(rstate)]), \
        rparams
    mstate, mtable, mparams, mobs, _ = problem(n_bins=324, device=device)
    jump = problem_jump_table(mstate, mtable, mobs, MTM_DELTA)
    yield "mtm_B91_K972", make_dense_scorer(mtable, mobs, device), \
        mtm_batch(mcmc.explode_genome(mstate), jump, 50), mparams
    cstate, ctable, cparams, cobs, cnb = problem(n_bins=967, device=device)
    yield "cli_K2901_B65", make_dense_scorer(ctable, cobs, device), \
        candidate_batch(cstate, cnb, 500, gen), cparams
    lstate, ltable, lparams, lobs, lnb = problem(n_bins=LARGE_BINS, device=device)
    yield "large_K6000_B13", make_dense_scorer(ltable, lobs, device), \
        candidate_batch(lstate, lnb, 11, gen, n_nb=1), lparams


def scan_io_check(label, build, chunks):
    """H2 and H3 against the plain versions on the trees one sampler's
    Scan builds: its cycle built with capture=False (the body run eagerly
    on the card, every step's tables built anew) and run for its first
    call, whose steps fill the buffers' capacity. The call's first load is
    held to ``scan_load_plain`` of row 0; each step's H3 launch to the
    plain sequence done first into copies of the scan's buffers, index and
    slots: ``scan_store_plain``, then ``scan_load_plain`` of the next row
    while it is below the capacity (else the slots as they were); every
    byte compared on the card. The first step's tensors and tables are kept
    to time the kernels alone: H2's, H3's, and the separate store-only and
    load-only tables of the same step. Returns the stats and the kept
    step."""
    import torch
    from graal_tpu_torch.core import graphs
    from graal_tpu_torch.ops import scan_cuda as scu

    diffs = []
    stats = dict(steps=0, load_launches=0, store_launches=0, last_at_capacity=False)
    kept = {}
    orig_preload, orig_store = graphs.Scan._preload, graphs.Scan._store

    def preload(self):
        orig_preload(self)
        diffs.append(bit_diffs(list(self.x_slots), scu.scan_load_plain(self.x_bufs, self.idx)))

    def raw(b):
        # a byte copy: a bool copy would turn the unwritten rows' bytes into 0 / 1
        return b.view(torch.uint8).clone().view(torch.bool) if b.dtype == torch.bool \
            else b.clone()

    def store(self, ys, new):
        y_c = [raw(b) for b in self.y_bufs]
        c_c = [raw(b) for b in self.carry_bufs]
        i_c = self.idx.clone()
        copy_of = {id(b): c for b, c in zip(self.carry_bufs, c_c)}
        mapped = [copy_of.get(id(v), v) for v in new]
        if stats["steps"] == 0:
            c_k = [raw(b) for b in c_c]
            copy_k = {id(b): c for b, c in zip(self.carry_bufs, c_k)}
            kept.update(scan=self, ys=list(ys), new=list(new), y_c=[raw(b) for b in y_c],
                        c_c=c_k, i_c=i_c.clone(), mapped=[copy_k.get(id(v), v) for v in new],
                        load=scu.load_tables(self.x_bufs, self.x_slots, self.idx),
                        step=scu.step_tables(self.y_bufs, ys, self.carry_bufs, new,
                                             self.x_bufs, self.x_slots, self.idx, self.ticket),
                        store_only=scu.step_tables(self.y_bufs, ys, self.carry_bufs, new, [],
                                                   [], self.idx, self.ticket))
        scu.scan_store_plain(y_c, ys, c_c, mapped, i_c)
        at_capacity = stats["steps"] + 1 == self.cap
        s_c = [raw(s) for s in self.x_slots] if at_capacity else \
            scu.scan_load_plain(self.x_bufs, i_c)
        orig_store(self, ys, new)
        diffs.append(bit_diffs(self.y_bufs + self.carry_bufs + [self.idx] + list(self.x_slots),
                               y_c + c_c + [i_c] + s_c))
        stats["steps"] += 1
        stats["last_at_capacity"] = at_capacity

    before = dict(scan_wrapper().launches.by_key())
    graphs.Scan._preload, graphs.Scan._store = preload, store
    try:
        cycle = build(False)
        call, _ = chunks[0]
        call(cycle, None)
        torch.cuda.synchronize()
    finally:
        graphs.Scan._preload, graphs.Scan._store = orig_preload, orig_store
    after = dict(scan_wrapper().launches.by_key())
    stats.update(load_launches=after.get("load", 0) - before.get("load", 0),
                 store_launches=after.get("store", 0) - before.get("store", 0),
                 differences=int(torch.stack(diffs).sum()))
    return stats, kept


def scan_entries_bytes(tables):
    return sum(t.e[j].outer * t.e[j].inner for t in tables for j in range(t.n))


def idle_step(tables, device):
    """``tables`` with the step index each advances written to a scratch
    cell (their ticket a scratch one), so that launching them again and
    again copies at one step; returns what must stay alive."""
    import torch

    cells = (torch.zeros(1, dtype=torch.int64, device=device),
             torch.zeros(1, dtype=torch.int32, device=device))
    for t in tables:
        if t.step_out:
            t.step_out, t.ticket = cells[0].data_ptr(), cells[1].data_ptr()
    return cells


def scan_io_times(kept):
    """H2 and H3 alone at one kept step (each launched from its tables,
    outside the wrapper's count, the index H3 advances written to a scratch
    cell, so each launch repeats the step), the same step's work as the
    separate store-only and load-only launches of before, the plain
    versions' ms as called and as graph replays (the plain store's index
    reset to that step first; H3's plain version the store then the next
    row's load), ``torch._foreach_copy_`` on the same carry leaves (the
    library call of H3's carry copies), and each bound: the bytes copied,
    read once and written once, with the step index."""
    import ctypes

    import torch
    from graal_tpu_torch.ops import scan_cuda as scu

    lib = scu.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    scan = kept["scan"]
    scan.idx.zero_()   # the kept step's row: H2 reads row 0, H3 writes it and loads row 1
    scratch = scan_scratch(kept["load"] + kept["step"] + kept["store_only"])
    cells = idle_step(kept["step"] + kept["store_only"], scan.idx.device)

    def launch(*parts):
        def go():
            for fn, tables in parts:
                for t in tables:
                    check(fn(ctypes.byref(t), stream) == 0, "scan launch failed")
        return go

    i_l = kept["i_c"].clone()   # 0, the kept step
    i_s = kept["i_c"].clone()

    def plain_load():
        return scu.scan_load_plain(scan.x_bufs, i_l)

    def plain_step():
        i_s.copy_(kept["i_c"])
        scu.scan_store_plain(kept["y_c"], kept["ys"], kept["c_c"], kept["mapped"], i_s)
        return scu.scan_load_plain(scan.x_bufs, i_s) if 1 < scan.cap else None

    copies = [(c, v) for b, c, v in zip(scan.carry_bufs, kept["c_c"], kept["new"]) if v is not b]
    rec = {}
    for kind, go, tables, plain in (
            ("load", launch((lib.scan_load, kept["load"])), kept["load"], plain_load),
            ("store", launch((lib.scan_store, kept["step"])), kept["step"], plain_step)):
        t = timed(go, SCAN_TIME_ITERS)
        t.update(plain_ms=cuda_ms(plain, 5, n_warm=1), plain_device_ms=graph_device_ms(plain, 20),
                 library_ms=None, launches_a_step=len(tables),
                 entries=sum(x.n for x in tables))
        if kind == "store":
            sep = timed(launch((lib.scan_store, kept["store_only"]),
                               (lib.scan_load, kept["load"])), SCAN_TIME_ITERS)
            t.update(separate_ms=sep["ms"], separate_device_ms=sep["device_ms"],
                     separate_launches=len(kept["store_only"]) + len(kept["load"]))
            if copies:
                dst, src = [c for c, _ in copies], [v for _, v in copies]
                lib_t = timed(lambda: torch._foreach_copy_(dst, src), SCAN_TIME_ITERS)
                t.update(library_ms=lib_t["ms"], library_device_ms=lib_t["device_ms"],
                         library_leaves=len(copies))
        rec[kind] = with_share(t, bound(2 * scan_entries_bytes(tables) + 16))
    del scratch, cells
    return rec


def scan_cases(device, sc, rsc):
    """(label, build, chunks) of every sampler's Scan: the dense EM cycle
    (flagship), the tempered one (4 chains), dense MTM and MH, the 100k
    delta EM cycle and its 4 chains, the 20k repeat delta cycle, the 100k
    delta MTM and the 20k repeat delta MH cycles, and ScaleRunner.run's
    cycle end (a body with no per-step inputs)."""
    yield "dense_flagship", *dense_graph_case(device)[:2]
    yield "tempered_flagship", *tempered_graph_case(device)[:2]
    for variant in ("mtm", "mh"):
        yield f"{variant}_flagship", *mtm_graph_case(device, variant)[:2]
    yield "delta_100k", *delta_graph_case(sc)[:2]
    yield "chains_100k", *delta_graph_case(sc, chains=CHAINS)[:2]
    yield "repeat_delta_20k", *delta_graph_case(rsc)[:2]
    yield "delta_mtm_100k", *delta_mtm_graph_case(sc, "mtm")[:2]
    yield "delta_mh_repeat_20k", *delta_mtm_graph_case(rsc, "mh")[:2]
    yield "cycle_end_100k", *cycle_end_graph_case(sc)[:2]


def phase_io_kernels(device, sc, rsc):
    """3h. H1 (the dense scorers' vectors and parameter row:
    vectors_kernel) against its plain version at every dense path's shape,
    bit for bit; H2 and H3 (the captured cycle's loads and stores:
    scan_load_kernel, scan_store_kernel) against scan_load_plain /
    scan_store_plain on every sampler's Scan trees, every byte; each timed
    beside its bound (the timed launches counted on scratch counters); the
    launches the three kernels counted on the card equal the calls made to
    H1's wrapper and the launches H2 / H3's made, by key."""
    calls = {}
    reset_counted(vectors_wrapper(), calls)
    scan_wrapper().n_launches = 0
    with counting_io_calls(calls):
        phase_io_checks(device, sc, rsc)
    check_counted("3h H1", vectors_wrapper(), {"vectors": calls.get("vectors", 0)})
    check_counted("3h H2 H3", scan_wrapper(), {k: calls.get(k, 0) for k in ("load", "store")})
    return dict(vectors=VEC_SHAPES, scan=SCAN_TREES, calls=calls)


def phase_io_checks(device, sc, rsc):
    """Phase 3h's checks and timings (see :func:`phase_io_kernels`)."""
    print("dense vectors H1 vs plain at every dense path's shape, bit for bit (vectors, "
          "a, row)")
    for label, scorer, batch, params in vectors_cases(device):
        vectors_shape(label, scorer, batch, params)
    print("scan loads / steps H2, H3 vs the plain store-then-load on every sampler's Scan "
          "trees, every step, every byte")
    for label, build, chunks in scan_cases(device, sc, rsc):
        stats, kept = scan_io_check(label, build, chunks)
        steps = stats["steps"]
        loads = 1 if kept["scan"].x_bufs else 0
        check(stats["load_launches"] == loads and stats["store_launches"] == steps,
              f"{label}: {stats} (one H2 a call, one H3 a step)")
        check(stats["last_at_capacity"], f"{label}: the call's last step was not at capacity")
        rec = scan_io_times(kept)
        n_x, n_y = len(kept["scan"].x_bufs), len(kept["ys"])
        n_copy = sum(v is not b for b, v in zip(kept["scan"].carry_bufs, kept["new"]))
        print(f"  {label}: {steps} steps, {n_x} inputs, {n_y} outputs, {n_copy} of "
              f"{len(kept['new'])} carry leaves copied; differences {stats['differences']}")
        for name, r in rec.items():
            extra = ""
            if name == "store":
                extra = (f"; the separate store-only and load-only launches "
                         f"({r['separate_launches']}) {r['separate_device_ms']:.4f} device ms "
                         f"({r['separate_ms']:.4f} as called)")
            if r.get("library_leaves"):
                extra += (f"; torch._foreach_copy_ on the {r['library_leaves']} carry leaves "
                          f"{r['library_device_ms']:.4f} device ms ({r['library_ms']:.4f} as "
                          "called)")
            print(f"    {'H2 load' if name == 'load' else 'H3 step'}: {r['entries']} entries in "
                  f"{r['launches_a_step']} launch(es); {r['device_ms']:.4f} device ms "
                  f"({r['ms']:.4f} as called); {fmt_bound(r)}; plain {r['plain_device_ms']:.4f} "
                  f"device ms as graph replays ({r['plain_ms']:.4f} as called){extra}")
        check(stats["differences"] == 0,
              f"{label}: {stats['differences']} values of H2 / H3 differ from plain")
        check(rec["store"]["launches_a_step"] == 1, f"{label}: H3's step was cut into "
              f"{rec['store']['launches_a_step']} launches")
        SCAN_TREES[label] = dict(stats=stats, kernels=rec, inputs=n_x, outputs=n_y,
                                 carry_copied=n_copy, carry=len(kept["new"]))
        del kept


def io_records():
    """The kernels line's entries of H1 (vectors), H2 (scan_load: a call's
    first load) and H3 (scan_store: a step's stores and the next step's
    loads): the dense flagship's numbers (H1: its EM step's B = 65; H2 /
    H3: its EM cycle's step), the other shapes of phase 3h under
    "by_shape", and under "by_path" each main path's launches counted on
    the card (phases 4, 4b, 7, 7b and the graphed cycles of 7g / 7h), whose
    sum is the top-level count; "max_abs_err" 0 (every value bit for bit;
    a difference fails 3h); H3's "library_ms" torch._foreach_copy_'s on
    the same carry leaves, and its "separate_ms" the same step as separate
    store-only and load-only launches."""
    out = []
    for kind, name, replaces, shapes, flagship in (
            ("vectors", "vectors", "graal_tpu/ops/likelihood_pallas.py:259", VEC_SHAPES,
             "dense_flagship_B65"),
            ("load", "scan_load", "graal_tpu/core/mcmc.py:468", SCAN_TREES, "dense_flagship"),
            ("store", "scan_store", "graal_tpu/core/mcmc.py:468", SCAN_TREES, "dense_flagship")):
        def rec_of(r):
            return r if kind == "vectors" else r["kernels"][kind]

        paths = {path: by_key[kind] for path, by_key in IO_PATHS.items() if by_key.get(kind)}
        check(paths, f"no main path launched the {name} kernel")
        rec = dict(rec_of(shapes[flagship]), max_abs_err=0, by_path=paths,
                   by_shape={label: rec_of(r) for label, r in shapes.items() if label != flagship})
        library = rec.pop("library_ms")
        source = "vectors.cu" if kind == "vectors" else "scan_io.cu"
        entry = kernel_record(name, source, replaces, sum(paths.values()), rec)
        entry["library_ms"] = library
        out.append(entry)
    return out


def io_paths(records, want):
    """Keep each graphed path's H1-H3 launches (the graph run's, equal to
    the eager run's) for the kernels line: one H3 a step, one H2 a call
    and one H1 a dense scoring call (``want[name]`` = (steps, scoring
    calls, scan calls with per-step inputs))."""
    for name, (steps, scorer_calls, calls) in want.items():
        got = records[name]["graph"]["io"]
        need = io_want(steps, scorer_calls, calls)
        check(got == need, f"{name}: H1-H3 launches {got} != {need}")
        IO_PATHS[f"graph_{name}"] = got


def phase_graphs(device, sc, rsc):
    """7g. Each main path's cycle as a captured graph against the same
    cycle run eagerly (capture=False), on the same inputs: the dense
    flagship (2 cycles, f_t and parameters changed between them), the 100k
    delta path (cycle_for(1024, 4): MAIN_STEPS then 128 steps, one graph
    for both lengths), its 4 tempered chains (M = 20) and the 20k repeat
    delta path. Bit-equal states, likelihoods, metrics and launches."""
    print("graph vs eager: the main paths' cycles captured and run eagerly on the same "
          "inputs")
    out = {}
    out["dense_flagship"] = graph_vs_eager("dense flagship (B1), 2 cycles",
                                           *dense_graph_case(device))
    out["delta_100k"] = graph_vs_eager(f"100k delta path (B4 + B2), f_max {F_MAX}",
                                       *delta_graph_case(sc))
    out["chains_100k"] = graph_vs_eager(f"100k delta path, {CHAINS} chains (M = 20)",
                                        *delta_graph_case(sc, chains=CHAINS))
    out["repeat_delta_20k"] = graph_vs_eager(f"20k repeat delta path, f_max {F_MAX}",
                                             *delta_graph_case(rsc))
    # one C1 call a step: 2 cycles of the flagship's 384 fragments, 256 + 128 delta steps;
    # one head and one D3 launch a step, and on the dense path one tail
    for name, steps in (("dense_flagship", 2 * 384), ("delta_100k", MAIN_STEPS + 128),
                        ("chains_100k", MAIN_STEPS + 128), ("repeat_delta_20k", MAIN_STEPS + 128)):
        got = out[name]["graph"]["by_key"][-1]
        check(got == {"em": steps}, f"{name}: C1 launches {got} != one a step ({steps})")
        want_step_launches(f"graph {name}", out[name]["graph"]["by_key"][-2], steps,
                           delta=name != "dense_flagship")
    catalogue_paths(out)
    corr_paths(out, {"repeat_delta_20k": MAIN_STEPS + 128})
    rows_paths(out, {name: MAIN_STEPS + 128
                     for name in ("delta_100k", "chains_100k", "repeat_delta_20k")})
    io_paths(out, {"dense_flagship": (2 * 384, 4 * 384, 2),
                   **{name: (MAIN_STEPS + 128, 0, 2)
                      for name in ("delta_100k", "chains_100k", "repeat_delta_20k")}})
    return out


def phase_graphs_top(sc):
    """11g. Graph against eager on 11e's 4 chains at bucket 16,384 (the
    truth, M = 20), with the peak memory of each."""
    print(f"graph vs eager at bucket {TOP_TIERS[1]}: {CHAINS} chains from the truth")
    name = f"chains_top_{TOP_TIERS[1]}"
    out = {name: graph_vs_eager(
        f"{CHAINS} chains at bucket {TOP_TIERS[1]} (M = 20)",
        *delta_graph_case(sc, chains=CHAINS, f_max=TOP_TIERS[1],
                          steps=(TOP16_CHAIN_STEPS, TOP16_CHAIN_STEPS // 2),
                          start=sc["truth"]))}
    rows_paths(out, {name: TOP16_CHAIN_STEPS + TOP16_CHAIN_STEPS // 2})
    return out


def tempered_graph_case(device, n_bins=384):
    """The flagship dense problem's tempered cycle: CHAINS chains from the
    exploded start, all scored in one B1 launch at B = 260 a step;
    SAMPLER_STEPS steps on the ladder up to T = 4, then half as many at 0.8
    x the ladder."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer
    from graal_tpu_torch.parallel import tempering

    state, table, params, obs, nb = problem(n_bins=n_bins, device=device)
    scorer = make_dense_scorer(table, obs, device)
    n = state.n_frags
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    start = mcmc.explode_genome(state)
    states = GenomeState(*[x.expand(CHAINS, -1).clone() for x in start])
    l0 = scorer(GenomeState(*[x[None] for x in start]), params)[0].expand(CHAINS).clone()
    ladder = torch.as_tensor(tempering.temperature_ladder(CHAINS, t_max=4.0), device=device)
    chunks = []
    for steps, scale in ((SAMPLER_STEPS, 1.0), (SAMPLER_STEPS // 2, 0.8)):
        orders = torch.stack([torch.randperm(n, generator=gen, device=device)[:steps]
                              for _ in range(CHAINS)])
        draws = tempering.draw_chain_inputs(gen, nb, DELTA, CHAINS, (steps,))

        def call(cycle, carry, orders=orders, draws=draws, f_ts=ladder * scale):
            cur, l_ts = carry or (states, l0)
            cur, l_ts, ncs = cycle(cur, draws, params, orders, l_ts, f_ts)
            return (cur, l_ts), (cur, l_ts, ncs)

        chunks.append((call, steps))

    def build(capture):
        return tempering.make_tempered_cycle(table, obs, nb, DELTA, scorer=scorer,
                                             capture=capture)

    return build, chunks, [scorer, step_wrapper(), catalogue_wrapper()]


def move_chunks(start, params, l0, jump, gen):
    """The two calls of an MTM / MH path: SAMPLER_STEPS steps at f_t 1 (a
    Python float, as the runners pass it), then half as many at f_t 0.8
    with the parameters perturbed (fact x 1.02)."""
    import torch
    from graal_tpu_torch.core import mtm

    device = start.pos.device
    chunks = []
    for k, (n_steps, f_t) in enumerate(((SAMPLER_STEPS, 1.0), (SAMPLER_STEPS // 2, 0.8))):
        order = torch.randperm(start.n_frags, generator=gen, device=device)[:n_steps]
        draws = mtm.draw_move_inputs(gen, jump, (n_steps,))

        def call(cycle, carry, order=order, draws=draws, f_t=f_t, k=k):
            cur, l_t = carry or (start, l0)
            par = params._replace(fact=params.fact * 1.02) if k else params
            cur, l_t, ys = cycle(cur, draws, par, order, l_t, f_t)
            return (cur, l_t), (cur, l_t, ys)

        chunks.append((call, n_steps))
    return chunks


def mtm_graph_case(device, variant, n_bins=384):
    """The flagship dense problem's MTM (or MH) cycle from the exploded
    start, with its jump table (``entry.problem_jump_table``, MTM_DELTA
    partners): each pass of a step one B1 launch at B = 91."""
    import torch
    from graal_tpu_torch.core import mcmc, mtm
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem, problem_jump_table
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    state, table, params, obs, _ = problem(n_bins=n_bins, device=device)
    scorer = make_dense_scorer(table, obs, device)
    jump = problem_jump_table(state, table, obs, MTM_DELTA)
    start = mcmc.explode_genome(state)
    l0 = scorer(GenomeState(*[x[None] for x in start]), params)[0]
    gen = torch.Generator(device=device).manual_seed(SEED + 23)

    def build(capture):
        return mtm.make_mtm_cycle(table, obs, jump, variant=variant, scorer=scorer,
                                  capture=capture)

    return build, move_chunks(start, params, l0, jump, gen), [scorer, catalogue_wrapper(),
                                                               move_wrapper()]


def delta_mtm_graph_case(sc, variant):
    """A delta MTM (or MH) path on B4 + B2 as ``ScaleRunner.run_mtm`` builds
    its cycle at f_max F_MAX (the MH catalogue, M = 7 neighbour slots, each
    pass one B4 and one B2 launch), from the set-up's shuffled start."""
    import torch
    from graal_tpu_torch.core.mtm import make_delta_mtm_cycle
    from graal_tpu_torch.ops.mini_grid_cuda import MiniGridScorer
    from graal_tpu_torch.ops.obsgrid_cuda import WindowObsGrid

    runner, start, params = sc["runner"], sc["shuf"], sc["params"]
    jump = runner.jump_table(MTM_DELTA, start.n_frags)
    grid, mini = WindowObsGrid(), MiniGridScorer()
    l0 = runner.anchor_fn()(start, params)
    gen = torch.Generator(device=start.pos.device).manual_seed(SEED + 24)

    def build(capture):
        return make_delta_mtm_cycle(sc["table"], jump, F_MAX, sc["sobs"], variant=variant,
                                    band_w=runner.w, obs_grid=grid, mini_grid=mini,
                                    rep=start.rep, capture=capture)

    return build, move_chunks(start, params, l0, jump, gen), repeat_kernels(sc) + [
        rows_wrapper(), mini, grid, catalogue_wrapper(), move_wrapper()]


def cycle_end_graph_case(sc, n_cycles=4):
    """``ScaleRunner.run``'s cycle end (the sparse re-anchor and the
    nuisance step, nuisance on) on the set-up's shuffled start, one call a
    cycle for ``n_cycles`` cycles, the parameters carried from call to call
    and f_t alternating 1 and 0.8; the draws drawn from a generator before
    each call, as the runner draws them."""
    import torch
    from graal_tpu_torch.core.mcmc import draw_nuisance_inputs

    runner, state, params = sc["runner"], sc["shuf"], sc["params"]
    gen = torch.Generator(device=state.pos.device).manual_seed(SEED + 25)
    chunks = []
    for k in range(n_cycles):
        def call(end, carry, draws=draw_nuisance_inputs(gen), f_t=(1.0, 0.8)[k % 2]):
            par, l_anchor, l_t = end(state, carry or params, f_t, draws)
            return par, (par, l_anchor, l_t)

        chunks.append((call, 1))

    def build(capture):
        return runner.cycle_end(True, capture=capture)

    return build, chunks, [step_wrapper()]


def run_mtm_memory(runner, start, steps, f_max_min, label):
    """``ScaleRunner.run_mtm``, one cycle of ``steps`` steps: B2 and B4
    twice a step (their counts read from the card), the peak memory, and
    no graph held once it returns (every scan of the runner released, and
    the memory allocated after it within 0.5 GB of before). Returns the
    record."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    peak = PeakMemory()
    move_wrapper().n_launches = rows_wrapper().n_launches = inputs_wrapper().n_launches = 0
    t0 = time.perf_counter()
    final, l_t, m = runner.run_mtm(start, n_cycles=1, steps_per_cycle=steps,
                                   f_max_min=f_max_min, progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want_move_launches(f"run_mtm {label}", move_launches(), steps)
    want_rows_launches(f"run_mtm {label}".replace(" ", "_"), rows_launches(), 2 * steps)
    peak_gb = peak.read(f"{label}, run_mtm at bucket {m['f_max'][0]}")[0]
    del final
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    held = [k for k, c in runner._cycles.items() if c.scan.graph is not None]
    launches = m["launches"]
    print(f"  {label}: bucket {m['f_max'][0]}, {steps} steps, launches {launches}, "
          f"{seconds:.3f} s; allocated {before / 1e9:.3f} GB before, {after / 1e9:.3f} after "
          f"(reserved {torch.cuda.memory_reserved() / 1e9:.3f}); scans holding a graph {held}")
    check(launches == {"ll_mini": 2 * steps, "obsgrid": 2 * steps},
          f"{label}: launches {launches} != two of each a step")
    check(not held, f"{label}: scans {held} still hold a graph after run_mtm")
    check(after - before < 0.5e9, f"{label}: {(after - before) / 1e9:.3f} GB more allocated "
          "after run_mtm than before")
    return dict(f_max=m["f_max"][0], steps=steps, launches=launches, seconds=seconds,
                peak_gb=peak_gb, allocated_before_gb=before / 1e9, allocated_after_gb=after / 1e9)


def phase_graphs_samplers(device, sc, rsc):
    """7h. The sampler cycles besides EM and delta EM, each built twice,
    captured and with capture=False, and run on the same inputs: the
    tempered dense cycle (CHAINS chains, the flagship, B1 at B = 260), the
    dense MTM and MH cycles (the flagship with its jump table, B1 at B =
    91), the delta MTM cycle (the 100k problem at f_max F_MAX) and the
    delta MH cycle (the 20k repeat twin, the repeat engine v2), each
    SAMPLER_STEPS then SAMPLER_STEPS / 2 steps (one graph for both); and
    ScaleRunner.run's cycle end, nuisance on, 4 cycles. Bit-equal states,
    likelihoods, accept flags, contig counts, parameters and launches (by
    key, from the card); each run's first call under sync debug mode
    "error"; the peak memory of each. Then ScaleRunner.run_mtm holds no
    graph once it returns (run_mtm_memory)."""
    print("graph vs eager: the tempered, MTM / MH and delta MTM / MH cycles and the "
          "runner's cycle end, captured and run eagerly on the same inputs")
    steps = SAMPLER_STEPS + SAMPLER_STEPS // 2
    k = 3 * 384   # the flagship's K
    move_want = {"set": 2 * steps, "draw": steps, "accept": steps}   # E1-E3 a step

    def launched(rec, want, label):
        got = rec["graph"]["by_key"]
        check(got == want, f"{label}: launches by key {got} != {want}")

    out = {}
    out["tempered_flagship"] = graph_vs_eager(
        f"tempered flagship (B1 at B = 260), {CHAINS} chains",
        *tempered_graph_case(device), sync_error=True)
    launched(out["tempered_flagship"], [{str((260, k)): steps},
                                        {"step_head": steps, "select_dense": steps,
                                         "step_tail": steps},
                                        {"em": steps}], "tempered")
    STEP_PATHS["graph_tempered_flagship"] = out["tempered_flagship"]["graph"]["by_key"][1]
    for variant in ("mtm", "mh"):
        out[f"{variant}_flagship"] = graph_vs_eager(
            f"dense {variant.upper()} flagship (B1 at B = {MTM_SLOTS})",
            *mtm_graph_case(device, variant), sync_error=True)
        launched(out[f"{variant}_flagship"],
                 [{str((MTM_SLOTS, k)): 2 * steps}, {"mh": 2 * steps}, move_want], variant)
        MOVE_PATHS[f"graph_{variant}_flagship"] = out[f"{variant}_flagship"]["graph"]["by_key"][2]
    out["delta_mtm_100k"] = graph_vs_eager(
        f"100k delta MTM (B4 + B2, M = 7), f_max {F_MAX}", *delta_mtm_graph_case(sc, "mtm"),
        sync_error=True)
    out["delta_mh_repeat_20k"] = graph_vs_eager(
        f"20k repeat delta MH (B4 + B2, M = 7), f_max {F_MAX}",
        *delta_mtm_graph_case(rsc, "mh"), sync_error=True)
    corr_want = [{"frozen": 2 * steps, "sums": 2 * steps}]   # two scoring calls a step
    rows_want = [{"counts": 2 * steps, "write": 2 * steps, "gather": 2 * steps}]
    for name, corr in (("delta_mtm_100k", []), ("delta_mh_repeat_20k", corr_want)):
        launched(out[name], corr + rows_want + [{"None": 2 * steps}] * 2
                 + [{"mh": 2 * steps}, move_want], name)
        MOVE_PATHS[f"graph_{name}"] = out[name]["graph"]["by_key"][-1]
    catalogue_paths(out)
    corr_paths(out, {"delta_mh_repeat_20k": 2 * steps})
    rows_paths(out, {name: 2 * steps for name in ("delta_mtm_100k", "delta_mh_repeat_20k")})
    io_paths(out, {"tempered_flagship": (steps, steps, 2),
                   "mtm_flagship": (steps, 2 * steps, 2), "mh_flagship": (steps, 2 * steps, 2),
                   "delta_mtm_100k": (steps, 0, 2), "delta_mh_repeat_20k": (steps, 0, 2)})
    out["cycle_end_100k"] = graph_vs_eager(
        "100k ScaleRunner.run cycle end (re-anchor + nuisance step)",
        *cycle_end_graph_case(sc), sync_error=True)
    launched(out["cycle_end_100k"], [{"step_head": 4, "step_tail": 4}],
             "cycle end")
    STEP_PATHS["graph_cycle_end_100k"] = out["cycle_end_100k"]["graph"]["by_key"][0]
    io_paths(out, {"cycle_end_100k": (4, 0, 4)})
    sc["runner"].release_graphs()
    out["run_mtm_100k"] = run_mtm_memory(sc["runner"], sc["shuf"], SAMPLER_STEPS, F_MAX,
                                         "100k delta MTM")
    return out


def phase_mtm_top(sc):
    """11h. (``--top-tiers`` only) ScaleRunner.run_mtm from the truth
    (bucket 16,384, M = 7 a pass, two passes a step) for TOP16_CHAIN_STEPS
    steps: its peak memory, and no graph held once it returns."""
    from graal_tpu_torch.scale import ScaleRunner

    runner = ScaleRunner(sc["table"], sc["sobs"], sc["params"], nb=sc["runner"].nb)
    rec = run_mtm_memory(runner, sc["truth"], TOP16_CHAIN_STEPS, F_MAX,
                         "delta MTM from the truth")
    check(rec["f_max"] == TOP_TIERS[1], f"run_mtm ran at bucket {rec['f_max']}")
    return rec


def kernel_record(name, source, replaces, launches, record):
    """One entry of the kernels line: every key of the contract, the
    flagship shape's numbers, and the rest under their own keys."""
    return dict(name=name, route="cuda", source=f"graal_tpu_torch/csrc/{source}",
                replaces=replaces, launches=launches, library_ms=None, **record)


def catalogue_records(catalogue):
    """The kernels line's entries of C1 and C2: the flagship shape's numbers
    (C1: the EM step's B = 5; C2: an MTM pass's B = 7), the other shapes of
    phase 3c under "by_shape", and under "by_path" each main path's
    launches counted on the card (phases 4, 4b, 7, 7b and every graphed
    cycle of 7g / 7h, the graph's count, equal to the eager run's), whose
    sum is the top-level count."""
    out = []
    for kind, flagship, line in (("em", "em_flagship", 48), ("mh", "mh_flagship", 86)):
        paths = {name: by_key[kind] for name, by_key in CATALOGUE_PATHS.items()
                 if by_key.get(kind)}
        check(paths, f"no main path launched the {kind} catalogue")
        out.append(kernel_record(
            f"{kind}_catalogue", "candidates.cu", f"graal_tpu/core/candidates.py:{line}",
            sum(paths.values()), dict(
                catalogue[flagship], by_path=paths,
                by_shape={k: v for k, v in catalogue.items()
                          if k.startswith(kind) and k != flagship})))
    return out


def step_records(step):
    """The kernels line's entries of the step's head (step_head: D2's draw
    with D1's proposal), its tail (step_tail: D1's Metropolis test with the
    l_t select and the metrics) and D3 (select_commit): the dense
    flagship's numbers (the head with both parts, the tail with all three,
    D3's dense entry), the other shapes of phase 3d under "by_shape", and
    under "by_path" each main path's launches counted on the card (phases
    4, 4b, 7, 7b and the graphed cycles of 7g / 7h), whose sum is the
    top-level count; "max_abs_err" the largest difference from the plain
    version that phase 3d measured on the compared draws of every shape;
    "close" the draws of each shape whose two best keys lay within
    SLOT_ULPS ulps (either slot passes there, and the draw is compared only
    where the slots agree)."""
    from graal_tpu_torch.ops.step_cuda import GROUPS

    rec = step["records"]
    out = []
    for name, line, flagship in (("step_head", 144, "step_head_dense_flagship"),
                                 ("step_tail", 368, "step_tail_dense_flagship"),
                                 ("select_commit", 178, "select_dense_dense_flagship")):
        kinds = GROUPS[name]
        paths = {path: sum(by_key.get(k, 0) for k in kinds)
                 for path, by_key in STEP_PATHS.items()}
        paths = {k: v for k, v in paths.items() if v}
        check(paths, f"no main path launched the {name} kernel")
        shapes = {k: v for k, v in rec.items()
                  if k != flagship and any(k.startswith(kd + "_") for kd in kinds)}
        out.append(kernel_record(name, "step.cu", f"graal_tpu/core/mcmc.py:{line}",
                                 sum(paths.values()), dict(
                                     rec[flagship], max_abs_err=step["errs"][name],
                                     by_path=paths, by_shape=shapes,
                                     close=step["close"] if name == "select_commit" else None)))
    return out


def move_records(move):
    """The kernels line's entries of E1 (mtm_set), E2 (mtm_draw) and E3
    (mtm_accept): the dense flagship MTM shape's numbers, every other shape
    of phase 3e (and 10c's level-1 one) under "by_shape", and under
    "by_path" each main path's launches counted on the card (7h's graphed
    cycles and run_mtm, 10a, 10e), whose sum is the top-level count;
    "max_abs_err" the largest absolute difference from the plain version
    measured on the compared draws of every shape (E1 and E3: 0, every
    output bit for bit; E2: p_fwd, whose weight sum is summed in another
    order), "close" each shape's draws under the margin rules."""
    out = []
    flagship = MOVE_SHAPES["dense_flagship_mtm"]
    close = {label: dict(slot=r["stats"]["slot_close"], accept=r["stats"]["accept_close"])
             for label, r in MOVE_SHAPES.items()}
    rel = {label: r["errs"] for label, r in MOVE_SHAPES.items()}
    for kernel, name, line in (("set", "mtm_set", 124), ("draw", "mtm_draw", 181),
                               ("accept", "mtm_accept", 198)):
        paths = {path: by_key[kernel] for path, by_key in MOVE_PATHS.items() if by_key.get(kernel)}
        check(paths, f"no main path launched the {name} kernel")
        err = max(r["errs"]["p_fwd_abs"] for r in MOVE_SHAPES.values()) if kernel == "draw" else 0.0
        out.append(kernel_record(name, "mtm.cu", f"graal_tpu/core/mtm.py:{line}",
                                 sum(paths.values()), dict(
                                     flagship["kernels"][kernel], max_abs_err=err, by_path=paths,
                                     by_shape={label: r["kernels"][kernel]
                                               for label, r in MOVE_SHAPES.items()
                                               if label != "dense_flagship_mtm"},
                                     close=close, rel_err=rel)))
    return out


def kernels_line(dense, dense_launches, repeat, repeat_launches, delta, mini_launches,
                 repeat_delta, obs_launches, cli_runs, mtm_exact, chains, top, catalogue,
                 step, move):
    """The {"kernels": [...]} line from the phases' records; the B2 / B4
    launches are (100k path, 20k repeat path); ``cli_runs`` is
    :func:`phase_cli`'s record, whose counts and errors against the plain
    versions go under each kernel's "by_path" (cli_run, cli_run_delta,
    cli_scale, cli_run_repeats, cli_run_mtm, cli_run_tempered,
    cli_run_multilevel, cli_run_hic, cli_scale_mtm, cli_scale_multilevel,
    cli_scale_chains), with ``mtm_exact`` (phase 10f) as
    delta_mtm_exactness and ``chains`` (phases 11a, 11b) as
    run_chains_100k (this slice's main path, whose launches join the
    top-level count) and run_chains_repeat_20k; the chains' B2 / B4 shapes
    (M = 20) go under "by_shape". ``top`` (phase 8b) and ``chains["top"]``
    (phase 11e) are the main paths at the top tiers, run_top_R and
    run_chains_top_R under "by_path", whose launches join the top-level
    count too. ``catalogue`` (phase 3c) gives C1's and C2's entries
    (:func:`catalogue_records`), ``step`` (phase 3d) the head's, the tail's
    and D3's
    (:func:`step_records`), ``move`` (phase 3e) E1's, E2's and E3's
    (:func:`move_records`)."""
    c = cli_runs
    ch, chr_, cht = chains["main"], chains["repeat"], chains["top"]
    top_launches = [sum(r["launches"][i] for r in top.values())
                    + sum(r["launches"][i] for r in cht.values()) for i in (0, 1)]

    def entry(rec, key="launches", err="max_abs_err"):
        return dict(launches=rec[key], max_abs_err=rec[err])

    def by_path(launches, record, key):
        return {"delta_100k": dict(launches=launches[0]),
                "repeat_delta_20k": dict(launches=launches[1], **record),
                "cli_run_delta": entry(c["delta"], key, f"{key}_err"),
                "cli_scale": entry(c["scale"], key, f"{key}_err"),
                "cli_scale_mtm": dict(entry(c["scale_mtm"], key, f"{key}_err"),
                                      mtm_launches=c["scale_mtm"]["mtm"][key == "obs"]),
                "cli_scale_multilevel": entry(c["scale_multilevel"], key, f"{key}_err"),
                "delta_mtm_exactness": dict(
                    launches=mtm_exact[key],
                    bad_steps=sum(s["bad_steps"] for s in mtm_exact["stats"].values())),
                "run_chains_100k": dict(
                    launches=ch["launches"][key == "obs"], steps=ch["steps"], f_max=ch["f_max"],
                    max_abs_err=ch["ll_mini" if key == "mini" else "obsgrid"]["max_abs_err"]),
                "run_chains_repeat_20k": dict(
                    launches=chr_["launches"][key == "obs"], steps=chr_["steps"],
                    bad_steps=chr_["exact_bad_steps"],
                    max_abs_err=chr_["ll_mini" if key == "mini" else "obsgrid"]["max_abs_err"]),
                "cli_scale_chains": dict(
                    launches=c["scale_chains"]["launches"][key == "obs"],
                    max_abs_err=c["scale_chains"]["ll_mini" if key == "mini"
                                                  else "obsgrid"]["max_abs_err"]),
                **{name: dict(launches=r["launches"][key == "obs"], steps=r["steps"],
                              banded_calls=r["banded_calls"])
                   for name, r in top.items()},
                **{f"run_chains_top_{b}": dict(
                    launches=r["launches"][key == "obs"], steps=r["steps"], f_max=r["f_max"],
                    banded_calls=r["banded_calls"],
                    max_abs_err=r["ll_mini" if key == "mini" else "obsgrid"]["max_abs_err"])
                   for b, r in cht.items()}}

    def chain_shapes(name):
        out = {f"{name}_chains_R{ch[name]['R']}_M{ch[name]['M']}": ch[name]}
        bucket = ch.get("b2_bucket" if name == "ll_mini" else "b4_bucket")
        if bucket is not None:
            out[f"{name}_chains_R{bucket['R']}_M{bucket['M']}"] = bucket
        for tag, rec in (("repeat", chr_[name]), ("cli", c["scale_chains"][name])):
            out[f"{name}_chains_{tag}_R{rec['R']}_M{rec['M']}"] = rec
        for rec in cht.values():
            out[f"{name}_chains_R{rec[name]['R']}_M{rec[name]['M']}"] = rec[name]
        return out

    mini = dict(delta["ll_mini"], by_path=by_path(mini_launches, repeat_delta["ll_mini"],
                                                  "mini"))
    shape = c["scale_mtm"]["mtm_shape"]
    mini["by_shape"] = {f"B2_mtm_R{shape['R']}_M{shape['M']}": shape, **chain_shapes("ll_mini")}
    return {"kernels": [
        kernel_record("ll_dense", "ll_dense.cu", "graal_tpu/ops/likelihood_pallas.py:65",
                      dense_launches, dict(dense, by_shape=dict(
                          dense["by_shape"], B1_B91_mtm=c["stages"]["B91"],
                          B1_B260_tempered=c["tempered"]["B260"],
                          B1_K2901_B65=c["multilevel"]["K2901"]), by_path={
                          "dense_main": dict(launches=dense_launches),
                          "cli_run": entry(c["dense"]),
                          "cli_run_delta": entry(c["delta"], "dense", "dense_err"),
                          "cli_run_mtm": entry(c["stages"]),
                          "cli_run_tempered": entry(c["tempered"]),
                          "cli_run_multilevel": entry(c["multilevel"]),
                          "cli_run_hic": dict(launches=c["hic"]["launches"])})),
        kernel_record("ll_mini", "ll_mini.cu", "graal_tpu/ops/likelihood_pallas.py:340",
                      sum(mini_launches) + ch["launches"][0] + top_launches[0], mini),
        kernel_record("obsgrid", "obsgrid.cu", "graal_tpu/ops/obsgrid_pallas.py:52",
                      sum(obs_launches) + ch["launches"][1] + top_launches[1], dict(
                          delta["obsgrid"], by_path=by_path(obs_launches, repeat_delta["obsgrid"],
                                                            "obs"),
                          by_shape=chain_shapes("obsgrid"))),
        kernel_record("ll_repeat", "ll_repeat.cu", "graal_tpu/ops/likelihood_pallas.py:514",
                      repeat_launches, dict(repeat, by_path={
                          "dense_repeat_main": dict(launches=repeat_launches),
                          "cli_run_repeats": entry(c["repeat"])})),
        *catalogue_records(catalogue),
        *step_records(step),
        *move_records(move),
        *corr_records(),
        *rows_records(),
        *inputs_records(),
        *io_records(),
    ]}


PHASE_S = {}


def phase(name, fn, *args, **kw):
    """Run one phase; its seconds are printed and kept for the summary."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[name] = round(time.perf_counter() - t0, 1)
    print(f"[phase {name}: {PHASE_S[name]} s]", flush=True)
    return out


def main():
    t_start = time.perf_counter()
    device = phase_device()
    import torch

    phase("1 build", phase_build)
    sc = phase("set-up 100k", scale_setup, device)
    catalogue = phase("3c C1 C2", phase_catalogue, device, sc)
    rsc = phase("set-up 20k repeat", scale_repeat_setup, device)
    step = phase("3d head D3 tail", phase_step_kernels, device, sc, rsc)
    move = phase("3e E1 E2 E3", phase_move_kernels, device, sc, rsc)
    phase("3f F1 F2", phase_corr_kernels, device, rsc)
    phase("3g G1 G2 G3", phase_rows_kernels, device, sc, rsc)
    phase("3h H1 H2 H3", phase_io_kernels, device, sc, rsc)
    phase("3i I1 I2", phase_inputs_kernels, device, sc, rsc)
    dense = phase("2-3 B1", phase_kernel, device)
    dense_launches = phase("4 dense main", phase_main, device)
    repeat = phase("4a B3", phase_repeat_kernel, device)
    repeat_launches = phase("4b repeat main", phase_repeat_main, device)
    delta_timing = phase("5 B2 B4", phase_delta_kernels, device, sc)
    crossover = phase("5c routes", phase_crossover, sc)
    phase("6 exactness", phase_exactness, device)
    phase("6a repeat exactness", phase_repeat_exactness, device)
    mini_launches, obs_launches = phase("7 delta main", phase_scale_main, sc)
    repeat_delta_timing = phase("7a repeat B2 B4", phase_repeat_delta_kernels, device, rsc)
    r_mini, r_obs = phase("7b repeat delta main", phase_scale_main, rsc,
                          "repeat delta main path")
    graphs = phase("7g graph vs eager", phase_graphs, device, sc, rsc)
    graphs.update(phase("7h samplers graph vs eager", phase_graphs_samplers, device, sc, rsc))
    phase("8 runner", phase_runner, sc)
    top = phase("8b runner top tiers", phase_runner_top, sc)
    chains = phase("11a chains", phase_chains, sc)
    top_chains = phase("11e chains top buckets", phase_chains_top, sc)
    del sc
    phase("8a repeat runner", phase_runner, rsc, steps=256)
    chains_rep = phase("11b repeat chains", phase_chains_repeats, rsc)
    del rsc
    cli_runs = phase("9-11c CLI", phase_cli, device)
    mtm_exact = phase("10g MTM exactness", phase_mtm_exactness, device)
    dist = phase("11d distribution", phase_dist, device)
    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all; phases {json.dumps(PHASE_S)}",
          flush=True)
    line = gpu_line()
    kernels = kernels_line(dense, dense_launches, repeat, repeat_launches, delta_timing,
                           (mini_launches, r_mini), repeat_delta_timing, (obs_launches, r_obs),
                           cli_runs, mtm_exact, dict(main=chains, repeat=chains_rep,
                                                     top=top_chains), top, catalogue,
                           step, move)
    print(json.dumps({"routes": crossover}))
    kernel_keys = ("ll_mini", "obsgrid", "b2_bucket", "b4_bucket")
    print(json.dumps({"chains": {
        name: {k: v for k, v in rec.items() if k not in kernel_keys}
        for name, rec in (("run_chains_100k", chains), ("run_chains_repeat_20k", chains_rep),
                          ("cli_scale_chains", cli_runs["scale_chains"]),
                          *((f"run_chains_top_{b}", r) for b, r in top_chains.items()))},
        "run_top": top,
        "distribution": dist,
        "graphs": graphs}))
    print(line)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main_top():
    """``--top-tiers``: the build, the 100k set-up and the phases of the top
    tiers (5 at every tier, 8b, 11e, 11g, 11h, 5c); their records on one JSON line,
    then the same last lines as :func:`main` (no kernels line)."""
    t_start = time.perf_counter()
    device = phase_device()
    import torch

    phase("1 build", phase_build)
    sc = phase("set-up 100k", scale_setup, device)
    delta_timing = phase("5 B2 B4", phase_delta_kernels, device, sc)
    top = phase("8b runner top tiers", phase_runner_top, sc)
    top_chains = phase("11e chains top buckets", phase_chains_top, sc)
    graphs = phase("11g graph vs eager top", phase_graphs_top, sc)
    graphs["run_mtm_top"] = phase("11h run_mtm top", phase_mtm_top, sc)
    step_top = phase("3d D3 top", phase_step_top, sc)
    catalogue_top = phase("3c C1 C2 top", phase_catalogue_top, sc)
    move_top = phase("3e E1-E3 top", phase_move_top, sc)
    rows_top = phase("3g G1-G3 top", phase_rows_top, sc)
    inputs_top = phase("3i I1 I2 top", phase_inputs_top, sc)
    crossover = phase("5c routes", phase_crossover, sc)
    del sc
    rsc = phase("set-up 20k repeat", scale_repeat_setup, device)
    corr_top = phase("3f F1 F2 top", phase_corr_top, rsc)
    print(f"smoke --top-tiers: {time.perf_counter() - t_start:.1f} s in all; phases "
          f"{json.dumps(PHASE_S)}", flush=True)
    print(json.dumps({"tiers": {k: delta_timing[k]["tiers"] for k in ("ll_mini", "obsgrid")},
                      "routes": crossover, "run_top": top, "run_chains_top": top_chains,
                      "graphs": graphs, "step_top": step_top,
                      "catalogue_top": catalogue_top, "move_top": move_top,
                      "corr_top": corr_top, "rows_top": rows_top,
                      "inputs_top": inputs_top}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main_cards():
    """``--cards``: the build, then :func:`phase_cards`; the same last
    lines as :func:`main` (no kernels line: no kernel is checked here)."""
    device = phase_device()
    import torch

    phase_build()
    out = phase_cards(device)
    print(json.dumps({"cards": out}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:   # one rank of phase 11d's worlds
        rank, world, store, out, backend = sys.argv[2:7]
        dist_child(int(rank), int(world), store, out, backend)
        sys.exit(0)
    try:
        {("--cards",): main_cards, ("--top-tiers",): main_top}.get(tuple(sys.argv[1:]),
                                                                   main)()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
