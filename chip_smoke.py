#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port (graal_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: refuse to run without CUDA; print the card (nvidia-smi name and
   power limit), torch's and nvcc's versions.
2. Build: compile graal_tpu_torch/csrc/ll_dense.cu with nvcc (sm_90a) and
   print the build time and the compiler's register / spill report.
3. Kernel vs plain: the dense scorer kernel against its plain torch
   version on the same inputs, rtol 1e-4 (bench.py's standard), at the
   flagship K = 1,152 on 65-candidate batches built on the true genome, on
   its exploded start and on a state with a circularised contig; at B = 1
   (the nuisance shape); and at K = 6,000 on a 13-candidate batch. Each
   candidate's score must be bit-identical alone and in any batch. The
   kernel is also held to the direct-pmf oracle (rtol 1e-4) and, on a
   small problem, to the f64 loop oracle (rtol 5e-5, atol 0.5).
4. Main path: 3 EM cycles of the flagship problem from its exploded
   start, nuisance sampling on, every score through the kernel. Checks the
   launch count, the invariants, that the carried likelihood equals the
   kernel's rescoring bit for bit, that the likelihood rose, and that a
   second run with the same seed is identical.
5. Last lines: the nvidia-smi line, one JSON line per the kernels run, and
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
    from graal_tpu_torch.ops.likelihood_cuda import _find_nvcc

    print(f"gpu: {gpu_line()}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    print(f"nvcc: {run_cmd([_find_nvcc(), '--version']).splitlines()[-1]}")
    return torch.device("cuda", 0)


def phase_build():
    from graal_tpu_torch.ops.likelihood_cuda import load_library

    t0 = time.perf_counter()
    _, so = load_library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


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


def main():
    device = phase_device()
    import torch

    phase_build()
    timing = phase_kernel(device)
    launches = phase_main(device)
    line = gpu_line()
    kernels = {"kernels": [{
        "name": "ll_dense",
        "route": "cuda",
        "source": "graal_tpu_torch/csrc/ll_dense.cu",
        "replaces": "graal_tpu/ops/likelihood_pallas.py:65",
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}
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
