#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port (graal_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: refuse to run without CUDA; print the card (nvidia-smi name and
   power limit), torch's and nvcc's versions.
2. Build: compile every kernel library (graal_tpu_torch/csrc/*.cu, sm_90a),
   one nvcc process each, all started together; print the build times and
   the compiler's register / spill report.
3. Dense kernel B1 (ll_dense) vs plain: the dense scorer kernel against its
   plain torch version on the same inputs, rtol 1e-4 (bench.py's
   standard), at the flagship K = 1,152 on 65-candidate batches built on
   the true genome, on its exploded start and on a state with a
   circularised contig; at B = 1 (the nuisance shape); and at K = 6,000 on
   a 13-candidate batch. Each candidate's score must be bit-identical alone
   and in any batch. The kernel is also held to the direct-pmf oracle
   (rtol 1e-4) and, on a small problem, to the f64 loop oracle (rtol 5e-5,
   atol 0.5).
4. Dense main path: 3 EM cycles of the flagship problem from its exploded
   start, nuisance sampling on, every score through the kernel. Checks the
   launch count, the invariants, that the carried likelihood equals the
   kernel's rescoring bit for bit, that the likelihood rose, and that a
   second run with the same seed is identical.
5. Delta kernels B4 (obsgrid) and B2 (ll_mini) vs plain, on the real step
   inputs of the chr1-class problem (100,000 fragments, full coverage,
   shuffled into 400 pieces) at f_max 1,024 for the 5 neighbour slots of a
   few fragments: B4 bit-identical; B2's scores within rtol 1e-4 and its
   deltas within DLL_ATOL; every genome's B2 score bit-identical alone and
   in its batch. Timed against the plain versions with CUDA events: B2 at
   R = 1,024 and at R = 4,096 (the top tier), B4 at R = 1,024.
6. Per-step exactness at 20,000 fragments: 10 single delta steps at f_max
   1,024; after each, the carried likelihood must be within
   max(0.5, 1e-6 |L|) of a full sparse re-anchor.
7. Delta main path at 100,000 fragments: ScaleRunner.cycle_for(1024, 4)
   for 256 steps from the shuffled start under
   torch.cuda.set_sync_debug_mode("error"). The carried likelihood must
   stay within 4e-6 |L| of a re-anchor, each step must launch B2 and B4
   once, and a second seeded run must be identical.
8. ScaleRunner.run at 100,000 fragments: 2 cycles of 512 extremity-first
   steps from f_max 256 up the tier ladder, nuisance sampling on; the
   invariants hold and the likelihood rises.
9. Last lines: the nvidia-smi line, one JSON line per the kernels run, and
   {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

RTOL = 1e-4                 # kernel vs plain / dense oracle (bench.py:59)
REF_RTOL, REF_ATOL = 5e-5, 0.5   # vs the f64 loop oracle (tests/test_parity.py)
N_CYCLES = 3
SEED = 0
LARGE_BINS = 2000           # K = 6,000: the largest table scored densely
SCALE_BINS = 100_000        # the chr1-class problem (bench_scale.py)
EXACT_BINS = 20_000         # benchmarks/check_exactness.py's size
F_MAX = 1024                # the flagship delta bucket
TOP_F_MAX = 4096            # the top tier of the shuffled 100k start
DELTA = 4
MAIN_STEPS = 256            # bench_scale.py's timed chunk
# B2 deltas, kernel vs plain: both sum f32 cells in f64, so they differ by
# the cells' last-ulp differences only; 0.05 is 10x below the 0.5 floor of
# the per-step exactness gate (phase 6) that a delta error would break.
DLL_ATOL = 0.05
DRIFT_REL = 4e-6            # carried vs re-anchored, 256 steps (bench.py:231)


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
    """Mean device time of fn() in ms (CUDA events around n_iter calls)."""
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


def circularised(state):
    """The true genome with contig 0 circularised (its ends pasted)."""
    import numpy as np
    import torch
    from graal_tpu_torch.core import ops
    from graal_tpu_torch.core.state import GenomeState

    s = state.to_numpy()
    members = np.nonzero(s["id_c"] == 0)[0]
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


def phase_kernel(device, n_bins=384, large_bins=LARGE_BINS):
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.likelihood import log_likelihood, log_likelihood_ref
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer, params_vector

    print("kernel vs plain:")
    state, table, params, obs, nb = problem(n_bins=n_bins, device=device)
    scorer = make_dense_scorer(table, obs, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    bases = {"true": state, "exploded": mcmc.explode_genome(state),
             "circular": circularised(state)}
    max_err = 0.0
    batches, scores = [], []
    for i, (name, base) in enumerate(bases.items()):
        batch = candidate_batch(base, nb, (7 + 100 * i) % state.n_frags, gen)
        got, err = kernel_vs_plain(scorer, batch, params, f"{name} candidates")
        max_err = max(max_err, err)
        batches.append(batch)
        scores.append(got)
        one = GenomeState(*[x[None] for x in base])
        got1, err = kernel_vs_plain(scorer, one, params, f"{name} genome (B=1)")
        max_err = max(max_err, err)
        if name != "circular":
            want = log_likelihood(base, table, scorer.obs, params)
            rel = abs(got1.item() - want.item()) / abs(want.item())
            print(f"    vs dense oracle log_likelihood: rel err {rel:.3g}")
            check(rel <= RTOL, f"{name}: kernel vs log_likelihood {rel} > {RTOL}")
    for batch, got, name in zip(batches, scores, bases):
        batch_invariance(scorer, batch, params, got, f"{name} candidates")
    all_batch = stack(batches)
    got_all = scorer(all_batch, params)
    check(torch.equal(got_all, torch.cat(scores)),
          "a 195-candidate batch differs from its three 65-candidate batches")
    print(f"  {all_batch.pos.shape[0]} candidates in one batch: bit-identical")

    # timing at the main path's shape: 65 candidates of the true genome
    # (every cell cis-or-trans as in an assembled map) and of the start
    vecs = scorer.sub_vectors(batches[0])
    pvec = params_vector(params, scorer.log_nfpb)
    timing = {}
    for name, b in (("true", batches[0]), ("exploded", batches[1])):
        v = scorer.sub_vectors(b)
        k_ms = cuda_ms(lambda: scorer.launch(*v, pvec), 50)
        p_ms = cuda_ms(lambda: scorer.plain(*v, pvec), 5, n_warm=1)
        timing[name] = (k_ms, p_ms)
        print(f"  time B=65 K={scorer.k} ({name} candidates): kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms")
    k1_ms = cuda_ms(lambda: scorer.launch(*[x[:1].contiguous() for x in vecs], pvec), 50)
    print(f"  time B=1 K={scorer.k}: kernel {k1_ms:.4f} ms")

    # the f64 loop oracle on a small problem
    s_state, s_table, s_params, s_obs, _ = problem(n_bins=24, n_contigs=3,
                                                   device=device)
    s_scorer = make_dense_scorer(s_table, s_obs, device)
    for name, st in (("true", s_state), ("exploded", mcmc.explode_genome(s_state))):
        got = s_scorer(GenomeState(*[x[None] for x in st]), s_params)[0].item()
        ref = log_likelihood_ref(st, s_table, s_obs, s_params)
        print(f"  small K={s_table.n_subs} {name}: kernel {got:.6f} vs f64 oracle {ref:.6f}")
        check(abs(got - ref) <= REF_ATOL + REF_RTOL * abs(ref),
              f"small {name}: kernel {got} vs f64 oracle {ref}")

    # the largest dense table: K ~ 6,000, one 13-candidate batch
    l_state, l_table, l_params, l_obs, l_nb = problem(n_bins=large_bins,
                                                      device=device)
    l_scorer = make_dense_scorer(l_table, l_obs, device)
    l_batch = candidate_batch(l_state, l_nb, 11, gen, n_nb=1)
    l_got, err = kernel_vs_plain(l_scorer, l_batch, l_params, "large candidates")
    batch_invariance(l_scorer, l_batch, l_params, l_got, "large candidates")
    lv = l_scorer.sub_vectors(l_batch)
    lp = params_vector(l_params, l_scorer.log_nfpb)
    lk_ms = cuda_ms(lambda: l_scorer.launch(*lv, lp), 20)
    lp_ms = cuda_ms(lambda: l_scorer.plain(*lv, lp), 2, n_warm=1)
    print(f"  time B=13 K={l_scorer.k}: kernel {lk_ms:.4f} ms, plain {lp_ms:.4f} ms")
    return dict(max_abs_err=max_err, ms=timing["true"][0], plain_ms=timing["true"][1])


def main_path_run(device, n_bins):
    """One seeded run: explode, then N_CYCLES EM cycles through the
    kernel. Returns the final state, params, l_t and what was measured."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import DELTA, problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer

    state, table, params, obs, nb = problem(n_bins=n_bins, device=device)
    scorer = make_dense_scorer(table, obs, device)
    cycle = mcmc.make_em_cycle(table, obs, nb, DELTA, sample_param=True,
                               scorer=scorer)
    n = state.n_frags
    gen = torch.Generator(device=device).manual_seed(SEED)
    cur = mcmc.explode_genome(state)
    torch.cuda.synchronize()
    scorer.n_launches = 0
    l0 = scorer(GenomeState(*[x[None] for x in cur]), params)[0]
    l_t, par = l0, params
    seconds = []
    for c in range(N_CYCLES):
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
                seconds=seconds, launches=launches, n=n)


def phase_main(device, n_bins=384):
    import numpy as np
    import torch
    from graal_tpu_torch.core.state import (GenomeState, check_invariants,
                                            derive_prev_next, dist_inter_genome)
    from graal_tpu_torch.entry import DELTA

    print(f"main path: {N_CYCLES} EM cycles, nuisance sampling on, f_t = 1")
    r = main_path_run(device, n_bins)
    n, scorer = r["n"], r["scorer"]
    steps = N_CYCLES * n
    want_launches = 1 + 2 * steps
    print(f"  kernel launches: {r['launches']} (path implies 1 + 2 x {steps} = "
          f"{want_launches})")
    check(r["launches"] == want_launches,
          f"kernel launches {r['launches']} != {want_launches}")
    check(check_invariants(r["cur"], raise_on_error=False) == [],
          "final state violates the invariants")
    rescored = scorer(GenomeState(*[x[None] for x in r["cur"]]), r["par"])[0]
    check(torch.equal(rescored, r["l_t"]),
          f"carried l_t {r['l_t'].item()!r} != rescored {rescored.item()!r}")
    check(r["l_t"].item() > r["l0"].item(),
          f"likelihood did not rise: {r['l0'].item()} -> {r['l_t'].item()}")
    init_prev, init_next = derive_prev_next(r["state"])
    # every bin has 3 sub-fragments (orientable); nothing is skipped
    dist = dist_inter_genome(r["cur"], init_prev, init_next, np.ones(n, np.int32),
                             np.ones(n, bool), np.zeros(n, bool))
    total_s = sum(r["seconds"])
    steady_s = sum(r["seconds"][1:])
    per_step = 13 * (DELTA + 1)
    print(f"  l_t {r['l0'].item():.3f} -> {r['l_t'].item():.3f} "
          f"(carried == rescored, bit for bit)")
    print(f"  n_contigs {int(r['cur'].n_contigs())} (true 16), "
          f"dist_inter_genome vs truth {dist:.4f}")
    print(f"  ms/step {total_s * 1e3 / steps:.4f} (all cycles), "
          f"{steady_s * 1e3 / (steps - n):.4f} (cycles 2-{N_CYCLES})")
    print(f"  candidate genomes scored per second: {per_step * steps / total_s:.1f} "
          f"(all), {per_step * (steps - n) / steady_s:.1f} (cycles 2-{N_CYCLES})")

    r2 = main_path_run(device, n_bins)
    same = all(torch.equal(a, b) for a, b in zip(r["cur"], r2["cur"]))
    check(same and torch.equal(r["l_t"], r2["l_t"]),
          "a second run with the same seed gave a different result")
    print("  second run with the same seed: identical final state and l_t")
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
    return dict(truth=truth, shuf=shuf, table=table, params=params, sobs=sobs,
                runner=runner, n=n_bins)


def delta_inputs(sc, scorer, f_a, gen):
    """The B4 and B2 inputs of one step of fragment f_a at the scorer's
    bucket, as the delta step builds them."""
    import torch
    from graal_tpu_torch.core import delta, mcmc

    shuf = sc["shuf"]
    f_a = torch.tensor(f_a, device=shuf.pos.device)
    ids, _ = mcmc.sample_neighbours(gen, f_a, shuf, sc["runner"].nb, DELTA)
    rows, valid, _ = delta.extract_rows_union(shuf, f_a, ids, scorer.f_max)
    subs, sub_valid = scorer.sub_rows(rows, valid)
    windows = scorer.windows(subs, sub_valid)
    _, geo, ob, accu_sub, pvec = scorer.inputs(shuf, f_a, ids, rows, valid, sc["params"],
                                               shuf.id_c.amax())
    return windows, scorer.mini_grid_args(geo, ob, accu_sub, pvec)


def b2_vs_plain(grid, args, label):
    """B2 kernel and plain version on the same inputs; returns (max abs
    score error, max abs dll error)."""
    import torch

    s_k, d_k = grid.launch(*args)
    s_p, d_p = grid.plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(s_k).all() & torch.isfinite(d_k).all()),
          f"{label}: non-finite B2 scores")
    err = (s_k.double() - s_p.double()).abs()
    rel = (err / s_p.double().abs().clamp_min(1e-30)).max().item()
    dll_err = (d_k.double() - d_p.double()).abs().max().item()
    m, c, r = args[0].shape
    print(f"  B2 {label}: M={m} C={c} R={r} max_abs_err={err.max().item():.6g} "
          f"max_rel_err={rel:.3g} dll max_abs_err={dll_err:.6g} "
          f"(|score| up to {s_p.abs().max().item():.6g})")
    check(rel <= RTOL, f"{label}: B2 kernel vs plain rel err {rel} > {RTOL}")
    check(dll_err <= DLL_ATOL, f"{label}: B2 dll error {dll_err} > {DLL_ATOL}")
    return s_k, err.max().item()


def phase_delta_kernels(device, sc, frags=(7, 31_337, 77_777)):
    import numpy as np
    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.scale import contig_frags_per_frag

    print(f"delta kernels vs plain ({sc['n']} fragments, shuffled start):")
    # a scorer with its own kernel wrappers: these launches are not the
    # main path's
    scorer = delta.make_delta_scorer(sc["table"], None, F_MAX, sobs=sc["sobs"])
    gen = torch.Generator(device=device).manual_seed(SEED)
    b2_err, b4_err, first = 0.0, 0.0, None
    for f_a in frags:
        win, args = delta_inputs(sc, scorer, f_a, gen)
        ob_k = scorer.obs_grid_kernel.launch(*win)
        ob_p = scorer.obs_grid_kernel.plain(*win)
        torch.cuda.synchronize()
        check(torch.equal(ob_k, ob_p), f"f_a={f_a}: B4 kernel differs from its plain version")
        b4_err = max(b4_err, (ob_k - ob_p).abs().max().item())
        print(f"  B4 f_a={f_a}: M={win[0].shape[0]} R={win[0].shape[1]} "
              f"cap={win[0].shape[2]}: bit-identical, {int((ob_k > 0).sum())} nonzero cells, "
              f"sum {ob_k.sum().item():.0f}")
        s_k, err = b2_vs_plain(scorer.mini_grid, args, f"f_a={f_a}")
        b2_err = max(b2_err, err)
        if first is None:
            first = (win, args, s_k)
    # each genome alone, and each neighbour alone, as in its batch
    win, args, s_k = first
    m, c, _ = args[0].shape
    for a in range(m):
        alone = scorer.mini_grid.launch(*[x[a:a + 1].contiguous() for x in args[:6]], args[6])[0]
        check(torch.equal(alone, s_k[a:a + 1]), f"neighbour {a} alone differs from its batch")
    for g in range(c):
        alone = scorer.mini_grid.launch(*[x[:1, g:g + 1].contiguous() for x in args[:5]],
                                        args[5][:1].contiguous(), args[6])[0]
        check(torch.equal(alone, s_k[:1, g:g + 1]), f"genome {g} alone differs from its batch")
    print(f"  B2: {m} neighbours and {c} genomes bit-identical alone and in the batch")

    k_ms = cuda_ms(lambda: scorer.mini_grid.launch(*args), 50)
    p_ms = cuda_ms(lambda: scorer.mini_grid.plain(*args), 5, n_warm=1)
    print(f"  time B2 R={args[0].shape[2]} M={m} C={c}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    o_ms = cuda_ms(lambda: scorer.obs_grid_kernel.launch(*win), 50)
    op_ms = cuda_ms(lambda: scorer.obs_grid_kernel.plain(*win), 10, n_warm=1)
    print(f"  time B4 R={win[0].shape[1]} cap={win[0].shape[2]} M={win[0].shape[0]}: "
          f"kernel {o_ms:.4f} ms, plain {op_ms:.4f} ms")

    # the top tier: a fragment of the largest contig at f_max 4,096
    top = delta.make_delta_scorer(sc["table"], None, TOP_F_MAX, sobs=sc["sobs"])
    f_big = int(np.argmax(contig_frags_per_frag(sc["shuf"])))
    _, args4 = delta_inputs(sc, top, f_big, gen)
    _, err4 = b2_vs_plain(top.mini_grid, args4, f"top tier f_a={f_big}")
    k4_ms = cuda_ms(lambda: top.mini_grid.launch(*args4), 10)
    p4_ms = cuda_ms(lambda: top.mini_grid.plain(*args4), 2, n_warm=1)
    print(f"  time B2 R={args4[0].shape[2]} M={args4[0].shape[0]}: kernel {k4_ms:.4f} ms, "
          f"plain {p4_ms:.4f} ms")
    return dict(ll_mini=dict(max_abs_err=max(b2_err, err4), ms=k_ms, plain_ms=p_ms),
                obsgrid=dict(max_abs_err=b4_err, ms=o_ms, plain_ms=op_ms))


def phase_exactness(device, n_bins=EXACT_BINS, steps=10):
    """Twin of benchmarks/check_exactness.py: single delta steps, each
    followed by a full sparse re-anchor. The steps are taken at contig
    extremities of the shuffled start, where a step joins pieces and
    commits a likelihood change well above the gate's tolerance; the phase
    fails unless some step does."""
    import numpy as np
    import torch
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.entry import scale_problem
    from graal_tpu_torch.scale import ScaleRunner

    _, shuf, table, params, sobs = scale_problem(n_bins, device=device)
    runner = ScaleRunner(table, sobs, params)
    step = delta.make_delta_em_step(table, None, runner.nb, DELTA, F_MAX, sobs=sobs,
                                    band_w=runner.w)
    anchor = runner.anchor_fn()
    gen = torch.Generator(device=device).manual_seed(SEED)
    pos, l_cont = shuf.pos.cpu().numpy(), shuf.l_cont.cpu().numpy()
    ext = np.nonzero((pos == 0) | (pos == l_cont - 1))[0]
    order = torch.as_tensor(ext, device=device)[
        torch.randperm(len(ext), generator=gen, device=device)[:steps]]
    cur, l_t = shuf, anchor(shuf, params)
    worst, bad, moved, above_tol, max_dl = 0.0, 0, 0, 0, 0.0
    for i in range(steps):
        new, l_new, (op, _, _) = step(cur, gen, params, l_t, order[i], 1.0)
        l_re = anchor(new, params)
        err = abs(l_new.item() - l_re.item())
        tol = max(0.5, 1e-6 * abs(l_re.item()))
        dl = abs(l_new.item() - l_t.item())
        bad += err > tol
        worst = max(worst, err)
        moved += int(op) >= 0
        above_tol += dl > tol
        max_dl = max(max_dl, dl)
        cur, l_t = new, l_re   # re-anchor: isolate each step's error
    print(f"per-step exactness: {json.dumps(dict(n_fragments=n_bins, f_max=F_MAX, steps=steps, moves=moved, steps_dl_above_tol=int(above_tol), max_abs_dl=max_dl, bad_steps=int(bad), worst_err=worst, L=l_t.item()))}")
    check(bad == 0, f"{bad} of {steps} delta steps drifted beyond max(0.5, 1e-6 |L|)")
    check(above_tol > 0, "no step committed a likelihood change above the gate's "
          "tolerance: the exactness gate was not exercised")


def scale_main_run(sc):
    """One seeded run of the delta main path: cycle_for(1024, 4) for
    MAIN_STEPS steps from the shuffled start, no synchronising call."""
    import torch

    runner, shuf, params = sc["runner"], sc["shuf"], sc["params"]
    device = shuf.pos.device
    cycle = runner.cycle_for(F_MAX, DELTA)
    gen = torch.Generator(device=device).manual_seed(SEED)
    order = torch.randperm(sc["n"], generator=gen, device=device)[:MAIN_STEPS]
    l0 = runner.anchor_fn()(shuf, params)
    torch.cuda.synchronize()
    runner.obs_grid.n_launches = runner.mini_grid.n_launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cur, l_t, out = cycle(shuf, gen, params, order, l0, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(cur=cur, l0=l0, l_t=l_t, out=out, seconds=seconds,
                launches=(runner.mini_grid.n_launches, runner.obs_grid.n_launches))


def phase_scale_main(sc):
    import torch

    print(f"delta main path: cycle_for({F_MAX}, {DELTA}), {MAIN_STEPS} steps from the "
          f"shuffled {sc['n']}-fragment start")
    r = scale_main_run(sc)
    l_re = sc["runner"].anchor_fn()(r["cur"], sc["params"])
    drift = abs(r["l_t"].item() - l_re.item())
    ops = r["out"][1]
    print(f"  l_t {r['l0'].item():.3f} -> {r['l_t'].item():.3f}, re-anchored {l_re.item():.3f}, "
          f"drift {drift:.6g} (bound {DRIFT_REL} |L| = {DRIFT_REL * abs(l_re.item()):.3f})")
    check(drift < DRIFT_REL * abs(l_re.item()), f"carried l_t drifted {drift} from the re-anchor")
    print(f"  moves committed {int((ops >= 0).sum())}/{MAIN_STEPS}, overflowed slots "
          f"{int(r['out'][3].sum())}, n_contigs {int(r['out'][4][-1])}")
    print(f"  launches: ll_mini {r['launches'][0]}, obsgrid {r['launches'][1]} "
          f"(path implies one of each per step: {MAIN_STEPS})")
    check(r["launches"] == (MAIN_STEPS, MAIN_STEPS), f"launches {r['launches']}")
    ms = r["seconds"] * 1e3 / MAIN_STEPS
    print(f"  {ms:.4f} ms/step, {13 * (DELTA + 1) * MAIN_STEPS / r['seconds']:.1f} candidate "
          f"genomes/s (13 x 5 per step; first run)")
    r2 = scale_main_run(sc)
    same = all(torch.equal(a, b) for a, b in zip(r["cur"], r2["cur"])) and \
        torch.equal(r["l_t"], r2["l_t"]) and \
        all(torch.equal(a, b) for a, b in zip(r["out"], r2["out"]))
    check(same, "a second run with the same seed gave a different result")
    ms2 = r2["seconds"] * 1e3 / MAIN_STEPS
    print(f"  second run with the same seed: identical; {ms2:.4f} ms/step, "
          f"{13 * (DELTA + 1) * MAIN_STEPS / r2['seconds']:.1f} candidate genomes/s")
    return r["launches"]


def phase_runner(sc, n_cycles=2, steps=512):
    import torch
    from graal_tpu_torch.scale import ScaleRunner

    print(f"ScaleRunner.run: {n_cycles} cycles x {steps} extremity-first steps, "
          f"f_max_min 256, nuisance sampling on")
    # a fresh runner (same neighbour table): its kernel counts are this run's
    runner = ScaleRunner(sc["table"], sc["sobs"], sc["params"], nb=sc["runner"].nb)
    l0 = runner.anchor_fn()(sc["shuf"], sc["params"]).item()
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
    del final, params


def main():
    device = phase_device()
    import torch

    phase_build()
    dense = phase_kernel(device)
    dense_launches = phase_main(device)
    sc = scale_setup(device)
    delta_timing = phase_delta_kernels(device, sc)
    phase_exactness(device)
    mini_launches, obs_launches = phase_scale_main(sc)
    phase_runner(sc)
    line = gpu_line()
    kernels = {"kernels": [
        dict(name="ll_dense", route="cuda", source="graal_tpu_torch/csrc/ll_dense.cu",
             replaces="graal_tpu/ops/likelihood_pallas.py:65", launches=dense_launches,
             **dense),
        dict(name="ll_mini", route="cuda", source="graal_tpu_torch/csrc/ll_mini.cu",
             replaces="graal_tpu/ops/likelihood_pallas.py:340", launches=mini_launches,
             **delta_timing["ll_mini"]),
        dict(name="obsgrid", route="cuda", source="graal_tpu_torch/csrc/obsgrid.cu",
             replaces="graal_tpu/ops/obsgrid_pallas.py:52", launches=obs_launches,
             **delta_timing["obsgrid"]),
    ]}
    print(line)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
