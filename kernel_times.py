#!/usr/bin/env python3
"""Time the port's CUDA kernels B1-B4, C1, D3, the step's head and tail,
F1 / F2, G1-G3 and H1-H3 at the shapes their paths give them, to hold one
tree's kernels against another's on one GPU.

    python3 kernel_times.py [--tree DIR] [--kernels B,C,D,F,G,H] [--sweep]

DIR holds a tree's ``graal_tpu_torch`` package (default: this checkout's).
That tree's wrappers build and launch its kernels, and its own problem
builders make the inputs from fixed seeds, so two trees whose builders
agree score the same inputs: the "check" sums of the scores then agree to
rtol 1e-4. To time an earlier commit's kernels against this tree's, unpack
its package into an ignored directory and run the trees in turns (earlier,
this, this, earlier) in one command on one card:

    mkdir -p build/earlier && git archive REV graal_tpu_torch | tar -x -C build/earlier
    for t in build/earlier . . build/earlier; do python3 kernel_times.py --tree $t; done

Each run prints, as its last line, one JSON object: the tree, the card
(nvidia-smi name and power limit) and, per shape, ms per call as called
and on the device alone (``chip_smoke.cuda_ms`` / ``device_ms``), and for
B2 and B4 the bound of the call and its share of the device time
(``chip_smoke.mini_bound`` / ``obsgrid_bound``; B2's counts what its
classes need and so only a tree whose package has ``tile_classes_plain``
gives it, with the class shares). The
shapes are those of ``chip_smoke.py``: B1 at B = 65 (true and exploded
candidates) and B = 1 on K = 1,152 and B = 13 on K = 6,000; B3 at B = 130
and 1 on S = 1,152 and B = 13 on S = 6,000; B2 at M = 5 on every tier
R = 256-16,384 of the 100k problem (the top tiers 8,192 and 16,384 on
the genome cut to fill them, ``chip_smoke.scale_setup``'s "tiered"), at
M = 20 (4 chains) on the buckets 8,192 and 16,384, and at M = 10, R =
1,024 on the 20k repeat problem; B4 at R = 1,024 on both, as the kernel
alone and as the step's whole production of its masked observed grid
from the CSR map and the keys ("B4 grid"), and at the top tiers and
buckets beside B2. C1 (the EM catalogue) at the EM step's call (B = 5,
n = 384), on the delta step's mini-states at bucket 1,024 (M = 5) and on
4 chains' at 16,384 (M = 20), both with the base slot; D3 (the selection
and commit) on the dense flagship step, the 100k delta step (M = 5) and
4 chains' at 16,384 (M = 20), its "check" the drawn slots' sum. The
step's head and tail ("head ..." / "tail ..."): a tree whose wrapper has
``step_head`` launches them; an earlier tree does the same work with its
own calls, so the two designs are timed on the same inputs: the dense EM
step's head (the draw and the nuisance proposal: D2 and D1's proposal
before) and tail (the l_t select, the Metropolis test and the cycle
metrics: D1's test and the body's torch glue before), the tempered
chains' head (the draw, C = 4) and tail (the select and the contig
counts), the cycle end's head (the proposal, 4 chains) and tail (the
test), and the 100k delta step's head (the draw); "check" sums their
outputs (equal across the two designs but on the tempered tail, which
computes mean_len beside the earlier body's count). H1 (the dense
scorers' vectors, "H1 ...") at phase 3h's eight shapes
(``chip_smoke.vectors_cases``), alone from one argument block and through
the scorer's wrapper ("... wrapper"); H2 / H3 ("H2 ..." / "H3 ...")
on the tables of each sampler's captured step (``chip_smoke.scan_cases``,
the first step's): "H3" a step's launches as the tree makes them (one H3
launch: the stores and the next step's loads; an earlier tree: its H2
then its H3), "H2" the call's first load, each with a "digest" (the
outputs' and carry buffers, the slots) two trees must share; and H3
alone on stores of 1-60 int32 carry leaves at 32 KB in all and of one
scalar each ("H3 sweep ..."), the cost an entry adds. F1 and F2 ("F1 ...", "F2 ...",
"F1+F2 ...") at phase 3f's shapes (``chip_smoke.corr_cases``) and G1-G3
("G1 ...", ..., "G1+G2 ...") at phase 3g's (``chip_smoke.rows_cases``)
and ``--top-tiers``' f_max 16,384 for 4 chains, one scoring call a shape:
each kernel alone from one argument block and the pair through its
wrapper, whose "digest" (sha256 of the outputs) must be equal across
trees, bit for bit. ``--kernels`` keeps the named groups (B: B1-B4, C:
C1, D: D3 and the head and tail, F: F1 / F2, G: G1-G3, H: H1-H3; default
all). ``--sweep`` (a tree whose wrappers have them) also times C1 and D3
under other cluster sizes (``candidates_cuda.plan``,
``step_cuda.select_cluster``), as "SHAPE [K=k]" entries, H1 under every
(threads, G) plan (``vectors_cuda.plan``), as "SHAPE [t=T G=g]", F1 under
every (K, router) plan (``repeat_corr_cuda.plan``), as "SHAPE [K=k
router]", each with "same": its outputs equal to the default plan's.
"""

import json
import sys
from pathlib import Path

import chip_smoke as smoke


def times(fn, check_of):
    """ms per call of fn() as called and on the device, and a checksum."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    # the checksum a leading slice at a time: an f64 copy of a whole
    # (20, 16384, 16384) grid would not fit beside it
    check = sum(float(x.double().sum()) for x in check_of(out))
    del out
    n_iter = max(10, min(200, int(50 / max(start.elapsed_time(stop), 0.01))))
    return dict(ms=smoke.cuda_ms(fn, n_iter), device_ms=smoke.device_ms(fn, n_iter),
                check=check)


def bounded(rec, b):
    """``rec`` with the bound ``b`` (chip_smoke.bound) and its share of the
    device time."""
    return dict(rec, bound_ms=b["bound_ms"], bound_by=b["bound_term"],
                share=b["bound_ms"] / rec["device_ms"])


def b2_times(scorer, args):
    """B2's times on ``args`` and, where this tree's package classes its
    (half tile, candidate) pairs, its bound and class shares."""
    from graal_tpu_torch.ops import mini_grid_cuda

    rec = times(lambda: scorer.mini_grid.launch(*args), lambda res: res[0])
    if not hasattr(mini_grid_cuda, "tile_classes_plain"):
        return rec
    cls, _ = smoke.mini_classes(args)
    return dict(bounded(rec, smoke.mini_bound(args, cls)), classes=smoke.class_shares(cls))


def dense_shapes(device, gen, build, name):
    """B1 or B3 (whichever the table gets) on a step's candidates of the
    ``build(n_bins)`` problem: at its flagship size, the whole batch at
    fragment 7 of the true genome, its first candidate alone and the batch
    at fragment 107 of the exploded start; at 2,000 bins, the 13 candidates
    of fragment 11 against one neighbour."""
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer, params_vector

    out = {}
    for n_bins, f_a, n_nb in ((384, 7, None), (smoke.LARGE_BINS, 11, 1)):
        state, table, params, obs, nb = build(n_bins)
        scorer = make_dense_scorer(table, obs, device)
        pvec = params_vector(params, scorer.log_nfpb)
        vecs = scorer.sub_vectors(smoke.candidate_batch(state, nb, f_a, gen, n_nb))
        shapes = {f"B={vecs[0].shape[0]}": vecs}
        if not n_nb:
            shapes["B=1"] = [x[:1].contiguous() for x in vecs]
            start = mcmc.explode_genome(state)
            shapes[f"B={vecs[0].shape[0]} exploded"] = scorer.sub_vectors(
                smoke.candidate_batch(start, nb, 107 % state.n_frags, gen))
        for label, v in shapes.items():
            out[f"{name} {label} K={scorer.k}"] = times(lambda: scorer.launch(*v, pvec),
                                                        lambda res: res)
    return out


def delta_shapes(sc, genome, scorer, extract, f_a, gen, label):
    """B2 and B4 on one step's inputs of fragment ``f_a`` of ``genome`` at
    the scorer's bucket; B4 alone and as the step's production of its
    masked observed grid (through the scorer, on I2's keys, activity
    folded in)."""
    import torch
    from graal_tpu_torch.core import delta, mcmc

    f_a = torch.tensor(f_a, device=genome.pos.device)
    ids, _ = mcmc.sample_neighbours(gen, f_a, genome, sc["runner"].nb, smoke.DELTA)
    rows, valid, _ = extract(genome, f_a, ids, scorer.f_max)
    _, vec, ob, pvec = scorer.inputs(*delta.lift_chain(genome, f_a, ids, rows, valid),
                                     sc["params"], genome.id_c.amax()[None])
    args = scorer.mini_grid_args(vec, ob, pvec)
    sobs = scorer.sobs
    b4 = (sobs.row_start, sobs.cols, sobs.vals, vec.keys)
    m, _, r = args[0].shape
    return {f"B2 {label} R={r} M={m}": b2_times(scorer, args),
            f"B4 {label} R={r} M={m}": bounded(times(lambda: scorer.obs_grid_kernel.launch(*b4),
                                                     lambda res: res), smoke.obsgrid_bound(b4)),
            f"B4 grid {label} R={r} M={m}": times(lambda: scorer.obs_grid(vec.keys),
                                                  lambda res: res)}


def chains_shapes(sc, genome, r, gen):
    """B2 and B4 on one step's inputs of 4 tempered chains from ``genome``
    at bucket ``r`` (M = 20, B2 with a parameter row per slot)."""
    from graal_tpu_torch.core import delta
    from graal_tpu_torch.core.state import GenomeState

    states = GenomeState(*[x.expand(smoke.CHAINS, -1).contiguous() for x in genome])
    scorer = delta.make_delta_scorer(sc["table"], None, r, sobs=sc["sobs"])
    b4, args, _ = smoke.chains_inputs(states, sc["runner"].nb, smoke.chain_params(sc["params"]),
                                      scorer, delta.extract_rows_union, gen)
    m = args[0].shape[0]
    return {f"B2 100k chains R={r} M={m}": b2_times(scorer, args),
            f"B4 100k chains R={r} M={m}": bounded(
                times(lambda: scorer.obs_grid_kernel.launch(*b4), lambda res: res),
                smoke.obsgrid_bound(b4))}


def catalogue_shapes(device, sc, gen, sweep):
    """C1 at the EM step's call, and on the mini-states of a delta step at
    bucket 1,024 (one chain) and 16,384 (4 chains); with ``sweep`` under
    other cluster plans too."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem
    from graal_tpu_torch.ops import candidates_cuda
    from graal_tpu_torch.ops.candidates_cuda import CATALOGUE

    state, _, _, _, nb = problem(n_bins=384, device=device)
    f = torch.tensor(7, device=device)
    ids, _ = mcmc.sample_neighbours(gen, f, state, nb, smoke.DELTA)
    shapes = {"C1 EM step B=5 n=384": (state, f, ids, None, False)}
    for r, starts in ((smoke.F_MAX, (sc["shuf"],)),
                      (smoke.TOP_TIERS[1], (sc["truth"], sc["tiered"], sc["halves"],
                                            sc["shuf"]))):
        st = GenomeState(*[torch.stack(xs) for xs in zip(*starts)])
        f_as = torch.randint(0, sc["n"], (len(starts),), generator=gen, device=device)
        minis, lf_a, lf_b, mx = smoke.mini_states(st, f_as, sc["runner"].nb, gen, r)
        shapes[f"C1 delta R={r} M={minis.pos.shape[0]} base"] = (minis, lf_a, lf_b, mx, True)
    plans = {"C1 EM step B=5 n=384": (1, 2),
             f"C1 delta R={smoke.F_MAX} M=5 base": (1, 2, 4),
             f"C1 delta R={smoke.TOP_TIERS[1]} M=20 base": (4, 8)}
    out = {}
    for label, (st, fa, fb, mx, wb) in shapes.items():
        def call():
            return CATALOGUE("em", st, fa, fb, mx, wb)

        out[label] = times(call, lambda res: res[:2])
        if not sweep:
            continue
        default = candidates_cuda.plan
        for k in plans.get(label, ()):
            candidates_cuda.plan = lambda n, k=k: k
            try:
                out[f"{label} [K={k}]"] = times(call, lambda res: res[:2])
            finally:
                candidates_cuda.plan = default
    return out


def select_shapes(device, sc, gen, sweep):
    """D3 on the dense flagship step (C = 1), the 100k delta step (M = 5)
    and 4 chains' at bucket 16,384 (M = 20), each commit into a copy of
    the genome; with ``sweep`` other cluster sizes too."""
    import torch
    from graal_tpu_torch.core import delta, mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem
    from graal_tpu_torch.ops import step_cuda
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer
    from graal_tpu_torch.ops.step_cuda import STEP

    state, table, params, obs, nb = problem(n_bins=384, device=device)
    s = smoke.dense_steps(state, nb, make_dense_scorer(table, obs, device), params, gen,
                          n_steps=1)[0]
    m = s["ids"].shape[0]
    st = GenomeState(*[x[None] for x in state])
    flat = GenomeState(*[x.reshape(1, m * 13, -1) for x in s["flat"]])
    gum = smoke.gumbel_noise((1, m * 13), gen, device)
    calls = {"D3 dense flagship C=1 m=5": lambda: STEP.select_dense(
        st, flat, s["ll"][None], s["ids"][None], s["valid"][None], s["f_a"].reshape(1), gum,
        1.0, nb.blacklist, mcmc.THRESH_OVERFLOW)[4]}
    runner = sc["runner"]
    for label, r, states, pc in (
            ("D3 delta 100k M=5", smoke.F_MAX, GenomeState(*[x[None] for x in sc["shuf"]]),
             sc["params"]),
            (f"D3 delta 4 chains R={smoke.TOP_TIERS[1]} M=20", smoke.TOP_TIERS[1],
             GenomeState(*[x.expand(smoke.CHAINS, -1).contiguous() for x in sc["truth"]]),
             smoke.chain_params(sc["params"]))):
        scorer = delta.make_delta_scorer(sc["table"], None, r, sobs=sc["sobs"])
        d = smoke.delta_steps(scorer, states, runner.nb, pc, delta.extract_rows_union, gen)
        del scorer
        c, m = d["ids"].shape
        g = smoke.gumbel_noise((c, m * 13), gen, device)
        dst = {f: x.clone() for f, x in d["states"]._asdict().items()}
        calls[label] = (lambda d=d, g=g, dst=dst: STEP.select_delta(
            dst, d["minis"]._asdict(), d["rows"], d["rows_valid"], d["dll"], d["ids"],
            d["valid"], d["overflow"], d["f_a"], g, 1.0, runner.nb.blacklist,
            mcmc.THRESH_OVERFLOW)[4])
    out = {label: times(fn, lambda res: [res]) for label, fn in calls.items()}
    if sweep:
        default = step_cuda.select_cluster
        for label, fn in calls.items():
            for k in (1, 2, 4, 8):
                step_cuda.select_cluster = lambda size, k=k: k
                try:
                    out[f"{label} [K={k}]"] = times(fn, lambda res: [res])
                finally:
                    step_cuda.select_cluster = default
    return out


def step_part_shapes(device, sc, gen):
    """The step's head and tail at the dense EM step's, the tempered
    chains', the cycle end's and the 100k delta step's shapes: one launch
    each on a tree whose wrapper has ``step_head``, else the earlier
    design's calls for the same work (see the module docstring)."""
    import torch
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.entry import problem
    from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer
    from graal_tpu_torch.ops.step_cuda import STEP

    new = hasattr(STEP, "step_head")
    state, table, params, obs, nb = problem(n_bins=384, device=device)
    nfpb = make_dense_scorer(table, obs, device).log_nfpb
    chains = GenomeState(*[torch.stack(xs) for xs in zip(
        state, mcmc.explode_genome(state), state, mcmc.explode_genome(state))])
    c = smoke.CHAINS
    u1 = torch.rand(nb.pk.shape[1], generator=gen, device=device)
    f1 = torch.tensor(7, device=device)
    uc = torch.rand((c, nb.pk.shape[1]), generator=gen, device=device)
    fc = torch.randint(0, state.n_frags, (c,), generator=gen, device=device)
    idm, eps = torch.tensor(0, device=device), torch.tensor(0.3, device=device)
    pc = smoke.chain_params(sc["params"])
    idm_c = torch.arange(c, device=device) % 4
    eps_c = torch.randn(c, generator=gen, device=device)
    l1, s1 = torch.tensor(-1.0e5, device=device), torch.tensor(-0.99999e5, device=device)
    test1 = params._replace(fact=params.fact * 1.01)
    ok1 = torch.tensor(True, device=device)
    lc = torch.full((c,), -1.0e5, device=device)
    sc_ = lc + torch.randn(c, generator=gen, device=device)
    testc = pc._replace(fact=pc.fact * 1.01)
    okc = torch.ones(c, dtype=torch.bool, device=device)
    shuf = sc["shuf"]
    f100 = torch.tensor(7, device=device)

    def old_tail(l_t, score, accept, st):
        """The earlier dense body's tail: its torch glue around D1's test."""
        l_t = torch.where(torch.isfinite(score), score, l_t)
        out = mcmc.nuisance_accept(*accept[:3], accept[3], l_t, *accept[4:])
        n_contigs = st.n_contigs()
        active_bp = torch.where(st.activ == 1, st.len_bp, 0).sum()
        return tuple(out[0]), out[1], out[2], n_contigs, active_bp.float() / n_contigs

    if new:
        calls = {
            "head dense EM C=1": lambda: STEP.step_head(
                (u1, f1, state.id_d, state.rep, nb, smoke.DELTA), (idm, eps, params, None, nfpb)),
            "tail dense EM C=1": lambda: STEP.step_tail(
                l1, s1, (u1[0], test1, params, s1, 1.0, ok1),
                (state.pos, state.activ, state.len_bp)),
            "head tempered C=4": lambda: STEP.step_head(
                (uc, fc, chains.id_d, chains.rep, nb, smoke.DELTA)),
            "tail tempered C=4": lambda: STEP.step_tail(
                lc, sc_, None, (chains.pos, chains.activ, chains.len_bp)),
            "head cycle end C=4": lambda: STEP.step_head(None, (idm_c, eps_c, pc, None, None)),
            "tail cycle end C=4": lambda: STEP.step_tail(
                lc, None, (uc[:, 0], testc, pc, sc_, 1.0, okc)),
            "head 100k M=5": lambda: STEP.step_head(
                (u1, f100, shuf.id_d, shuf.rep, sc["runner"].nb, smoke.DELTA)),
        }
    else:
        calls = {
            "head dense EM C=1": lambda: (
                STEP.neighbours(u1, f1, state.id_d, state.rep, nb, smoke.DELTA),
                STEP.nuisance_propose(idm, eps, params, None, nfpb)),
            "tail dense EM C=1": lambda: old_tail(l1, s1, (u1[0], test1, params, s1, 1.0, ok1),
                                                  state),
            "head tempered C=4": lambda: STEP.neighbours(uc, fc, chains.id_d, chains.rep, nb,
                                                         smoke.DELTA),
            "tail tempered C=4": lambda: (torch.where(torch.isfinite(sc_), sc_, lc),
                                          chains.n_contigs()),
            "head cycle end C=4": lambda: STEP.nuisance_propose(idm_c, eps_c, pc, None, None),
            "tail cycle end C=4": lambda: STEP.nuisance_accept(uc[:, 0], testc, pc, sc_, lc, 1.0,
                                                               okc),
            "head 100k M=5": lambda: STEP.neighbours(u1, f100, shuf.id_d, shuf.rep,
                                                     sc["runner"].nb, smoke.DELTA),
        }

    def flat(res):
        if isinstance(res, torch.Tensor):
            return [res]
        return [x for r in res if r is not None for x in flat(r)]

    return {label: times(fn, lambda res: [x for x in flat(res) if not x.dtype.is_complex])
            for label, fn in calls.items()}


def vectors_shapes(device, sweep):
    """H1 at phase 3h's shapes (``chip_smoke.vectors_cases``): the kernel
    alone from one argument block (its launches on a scratch counter, where
    the tree's block has one), and the scoring call's wrapper as a scorer
    calls it ("... wrapper": an earlier tree's torch counter add included);
    with ``sweep`` (a tree whose wrapper has ``plan``) the kernel alone
    under every (threads, G) plan too, as "H1 SHAPE [t=T G=g]" entries."""
    import ctypes

    import torch
    from graal_tpu_torch.ops import vectors_cuda as vc

    lib = vc.load_library()
    out = {}
    for label, scorer, batch, params in smoke.vectors_cases(device):
        def launch(a):
            stream = torch.cuda.current_stream().cuda_stream
            return lambda: smoke.check(lib.vectors(ctypes.byref(a), stream) == 0,
                                       "H1 launch failed")

        a, keep, outs = smoke.h1_args(batch, scorer, params)
        check_of = (lambda res, outs=outs: [x for x in outs[0]] + [outs[1]])
        b, k = batch.pos.shape[0], scorer.k
        out[f"H1 {label}"] = dict(times(launch(a), check_of), B=b, K=k)
        out[f"H1 {label} wrapper"] = times(lambda: scorer.vectors(batch, params),
                                           lambda res: list(res[0]) + [res[1]])
        if sweep and hasattr(vc, "plan"):
            default = vc.plan
            for threads in (64, 128, 256):
                for group in vc.GROUPS:
                    vc.plan = lambda b_, k_, t=threads, g=group: (t, g)
                    try:
                        a2, keep2, outs2 = smoke.h1_args(batch, scorer, params)
                    finally:
                        vc.plan = default
                    out[f"H1 {label} [t={threads} G={group}]"] = times(
                        launch(a2), lambda res, outs2=outs2: list(outs2[0]) + [outs2[1]])
                    del keep2
        del keep
    return out


def scan_tables(scu, scan, ys, new):
    """A captured step's scan launches as (kind, table) in order, and the
    call's first load, from the tables this tree's package builds: one H3
    launch a step (its stores and the next step's loads) where the package
    has ``step_tables``; an earlier tree's H2 then H3 (a step's load, then
    its stores)."""
    if hasattr(scu, "step_tables"):
        first = scu.load_tables(scan.x_bufs, scan.x_slots, scan.idx)
        return [("store", t) for t in scu.step_tables(
            scan.y_bufs, ys, scan.carry_bufs, new, scan.x_bufs, scan.x_slots, scan.idx,
            scan.ticket)], first
    first = scu.load_tables(scan.x_bufs, scan.x_slots, scan.idx, scan.step_cell)
    return [("load", t) for t in first] + [("store", t) for t in scu.store_tables(
        scan.y_bufs, ys, scan.carry_bufs, new, scan.idx, scan.step_cell)], first


def idle(tables):
    """Point the step index that ``tables`` advance (and this tree's ticket
    cell) at scratch cells, so that each launch repeats the same step;
    returns the cells, to keep alive."""
    import torch

    cells = (torch.zeros(1, dtype=torch.int64, device="cuda"),
             torch.zeros(1, dtype=torch.int32, device="cuda"))
    for t in tables:
        if t.step_out:
            t.step_out = cells[0].data_ptr()
            if any(name == "ticket" for name, _ in type(t)._fields_):
                t.ticket = cells[1].data_ptr()
    return cells


def scan_shapes(device, sc, rsc):
    """The scan I/O of a captured step on the tables of each sampler's Scan
    (``chip_smoke.scan_cases``, the first step's tensors), as this tree's
    package builds them: "H3 ..." a step's launches (one H3 launch: the
    stores and the next step's loads; an earlier tree: its H2 then its H3),
    "H2 ..." the call's first load; each launch on a scratch counter where
    the tree's table has one, the index it advances written to a scratch
    cell, so each repeat copies at step 0. "digest": sha256 of the outputs'
    and carry buffers after the step (H3) and of the slots after the load
    (H2), equal across trees."""
    import ctypes

    import torch
    from graal_tpu_torch.core import graphs
    from graal_tpu_torch.ops import scan_cuda as scu

    lib = scu.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    fns = {"load": lib.scan_load, "store": lib.scan_store}
    out = {}

    def launch(parts):
        def go():
            for kind, t in parts:
                smoke.check(fns[kind](ctypes.byref(t), stream) == 0, "scan launch failed")
        return go

    for label, build, chunks in smoke.scan_cases(device, sc, rsc):
        kept = {}
        orig = graphs.Scan._store

        def store(self, ys, new, kept=kept, orig=orig):
            if not kept:
                kept.update(scan=self, ys=list(ys), new=list(new),
                            tables=scan_tables(scu, self, ys, new))
            orig(self, ys, new)

        graphs.Scan._store = store
        try:
            call, _ = chunks[0]
            call(build(False), None)
            torch.cuda.synchronize()
        finally:
            graphs.Scan._store = orig
        scan = kept["scan"]
        step, first = kept["tables"]
        scan.idx.zero_()
        scratch = smoke.scan_scratch([t for _, t in step] + first)
        cells = idle([t for kind, t in step if kind == "store"])
        for name, parts, bufs in (
                ("H3", step, scan.y_bufs + scan.carry_bufs),
                ("H2", [("load", t) for t in first], scan.x_slots)):
            go = launch(parts)
            rec = times(go, lambda res, bufs=bufs: [b for b in bufs if not b.dtype.is_complex])
            go()
            torch.cuda.synchronize()
            out[f"{name} {label}"] = dict(
                rec, digest=digest(bufs), launches=len(parts),
                entries=sum(t.n for _, t in parts),
                bytes=smoke.scan_entries_bytes([t for _, t in parts]))
        del kept, scan, scratch, cells
    return out


def store_sweep(device, total_bytes=32768, counts=(1, 2, 4, 8, 16, 31, 48, 60)):
    """H3 alone on stores of n carry leaves (int32, contiguous) for each n
    of ``counts``: at ``total_bytes`` bytes in all ("H3 sweep n=N bytes=B")
    and of one 4-byte scalar each ("H3 sweep n=N scalars"), to measure the
    cost an entry adds at fixed bytes; the index each launch advances
    written to a scratch cell."""
    import ctypes

    import torch
    from graal_tpu_torch.ops import scan_cuda as scu

    lib = scu.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    idx = torch.zeros(1, dtype=torch.int64, device=device)
    step = torch.zeros(1, dtype=torch.int64, device=device)
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    out = {}
    for n in counts:
        for label, size in ((f"bytes={total_bytes}", total_bytes // 4 // n), ("scalars", 1)):
            gen = torch.Generator(device=device).manual_seed(n)
            new = [torch.randint(-99, 99, (size,), generator=gen, device=device,
                                 dtype=torch.int32) for _ in range(n)]
            bufs = [torch.zeros_like(v) for v in new]
            if hasattr(scu, "step_tables"):
                tables = scu.step_tables([], [], bufs, new, [], [], idx, ticket)
            else:
                tables = scu.store_tables([], [], bufs, new, idx, step)
            scratch = smoke.scan_scratch(tables)
            cells = idle(tables)

            def go(tables=tables):
                for t in tables:
                    smoke.check(lib.scan_store(ctypes.byref(t), stream) == 0,
                                "scan launch failed")

            out[f"H3 sweep n={n} {label}"] = dict(times(go, lambda res, bufs=bufs: bufs),
                                                  entries=n, launches=len(tables),
                                                  bytes=smoke.scan_entries_bytes(tables))
            del scratch, cells
    return out


def digest(tensors):
    """sha256 of the tensors' bytes, to hold two trees' outputs equal bit
    for bit."""
    import hashlib

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def corr_shapes(device, rsc, gen, sweep):
    """F1 and F2 at phase 3f's shapes (``chip_smoke.corr_cases``), on one
    scoring call a shape drawn from ``gen``: F1 alone and F2 alone from one
    argument block (their launches on a scratch counter where the tree's
    block has one) and the pair through the wrapper ("F1+F2 ..."), whose
    "digest" (sha256 of corr, cross and dll) two trees must share; with
    ``sweep`` (a tree whose wrapper has ``plan``) F1 alone under every
    (K, router) plan that fits, as "F1 SHAPE [K=k router]", each with
    "same": its F1 + F2 outputs equal to the default plan's."""
    import ctypes

    import torch
    from graal_tpu_torch.ops import repeat_corr_cuda as rc

    lib = rc.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}

    def launch(fn, a, what):
        return lambda: smoke.check(fn(ctypes.byref(a), stream) == 0, f"{what} launch failed")

    for case in smoke.corr_cases(device, rsc):
        args = smoke.corr_args(case, *case["draw"](gen))
        tables = case["engine"].corr_tables
        label = f"{case['label']} M={args[4].mid.shape[0]} R={args[4].mid.shape[2]}"
        pair = lambda: smoke.corr_wrapper().corrections(tables, *args)   # noqa: E731
        want = digest(pair())
        out[f"F1+F2 {label}"] = dict(times(pair, lambda res: list(res)), digest=want)

        def block():
            a, keep, outs = rc.call_args(tables, *args)
            counter = smoke.scratch_fields(a, ("frozen_counter", "sums_counter"))
            scratch = next(x for x in keep if isinstance(x, dict))
            return a, (keep, counter), outs, scratch

        a, keep, outs, scratch = block()
        f1, f2 = launch(lib.repeat_corr_frozen, a, "F1"), launch(lib.repeat_corr_sums, a, "F2")
        f1()
        f2()
        out[f"F1 {label}"] = times(f1, lambda res: [scratch["n_rec"]])
        out[f"F2 {label}"] = dict(times(f2, lambda res: list(outs)), digest=digest(outs))
        if sweep and hasattr(rc, "plan"):
            default = rc.plan
            r, f_max, n = args[4].mid.shape[2], args[2].shape[2], tables.sub_start.shape[0]
            for k in (1, 2, 4, 8):
                for router in rc.ROUTERS:
                    if rc.frozen_smem(r, f_max, n, k, router) > rc.SMEM_MOST:
                        continue
                    rc.plan = lambda r_, f_, n_, k=k, router=router: (k, router)
                    try:
                        a2, keep2, outs2, _ = block()
                    finally:
                        rc.plan = default
                    g1, g2 = launch(lib.repeat_corr_frozen, a2, "F1"), \
                        launch(lib.repeat_corr_sums, a2, "F2")
                    g1()
                    g2()
                    same = digest(outs2) == want
                    out[f"F1 {label} [K={k} {router}]"] = dict(
                        times(g1, lambda res, outs2=outs2: list(outs2)), same=same)
                    del keep2
        del keep
    return out


def rows_shapes(device, sc, rsc, gen):
    """G1-G3 at phase 3g's shapes (``chip_smoke.rows_cases``) and
    ``--top-tiers``' f_max 16,384 for 4 chains, on one extraction a shape
    drawn from ``gen``: G1, G2 and G3 alone from one argument block (their
    launches on a scratch counter where the tree's block has one) and G1 +
    G2 through the wrapper ("G1+G2 ..."), whose "digest" (sha256 of rows,
    valid, overflow and max_id) two trees must share."""
    import ctypes

    import torch
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.ops import rows_cuda as rc

    lib = rc.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    cases = smoke.rows_cases(device, sc, rsc)
    states = GenomeState(*[x.expand(smoke.CHAINS, -1).contiguous() for x in sc["truth"]])
    cases.append(smoke.rows_case(f"delta_100k_4_chains_{smoke.TOP_TIERS[1]}", sc,
                                 smoke.TOP_TIERS[1], states=states))
    out = {}

    def launch(fn, a, what):
        return lambda: smoke.check(fn(ctypes.byref(a), stream) == 0, f"{what} launch failed")

    for case in cases:
        f_a, ids = case["draw"](gen)
        st, f_max, union = case["states"], case["f_max"], case["union"]
        c, m = ids.shape
        label = (f"{case['label']} {'union' if union else 'each'} C={c} m={m} n={case['n']} "
                 f"f_max={f_max}")
        pair = lambda: smoke.rows_wrapper().extract(st.id_c, f_a, ids, f_max, union)  # noqa: E731
        want = digest(pair())
        out[f"G1+G2 {label}"] = dict(times(pair, lambda res: list(res)), digest=want)

        def block():
            a, keep, outs = rc.extract_args(st.id_c, f_a, ids, f_max, union)
            counter = smoke.scratch_fields(a, ("counts_counter", "write_counter"))
            return a, (keep, counter), outs

        a, keep, outs = block()
        g1, g2 = launch(lib.rows_counts, a, "G1"), launch(lib.rows_write, a, "G2")
        g1()
        g2()
        g, keep_g, mini = rc.gather_args(st, outs[0], outs[1])
        counter_g = smoke.scratch_fields(g, ("counter",))
        g3 = launch(lib.rows_gather, g, "G3")
        out[f"G1 {label}"] = times(g1, lambda res: [outs[3]])
        out[f"G2 {label}"] = dict(times(g2, lambda res: list(outs)), digest=digest(outs),
                                  chunks=a.n_chunks)
        out[f"G3 {label}"] = times(g3, lambda res: [mini])
        del keep, keep_g, counter_g
    return out


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(prog="kernel_times.py")
    ap.add_argument("--tree", default=".")
    ap.add_argument("--kernels", default="B,C,D,F,G,H")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    groups = set(args.kernels.split(","))
    smoke.check(groups <= {"B", "C", "D", "F", "G", "H"},
                f"--kernels: B, C, D, F, G or H, not {args.kernels}")
    sys.path.insert(0, str(tree))
    import torch
    from graal_tpu_torch.core import delta, delta_repeats
    from graal_tpu_torch.entry import problem, repeat_problem

    device = smoke.phase_device()
    import graal_tpu_torch
    smoke.check(Path(graal_tpu_torch.__file__).resolve().parent.parent == tree,
                f"graal_tpu_torch came from {graal_tpu_torch.__file__}, not {tree}")
    smoke.phase_build()
    gen = torch.Generator(device=device).manual_seed(smoke.SEED)
    out = {}
    if "B" in groups:
        out.update(dense_shapes(device, gen, lambda n: problem(n_bins=n, device=device), "B1"))
        out.update(dense_shapes(device, gen, lambda n: repeat_problem(n_bins=n, device=device),
                                "B3"))

    sc = smoke.scale_setup(device)
    if "C" in groups:
        out.update(catalogue_shapes(device, sc, gen, args.sweep))
    if "D" in groups:
        out.update(select_shapes(device, sc, gen, args.sweep))
        out.update(step_part_shapes(device, sc, gen))
    if "H" in groups:
        out.update(vectors_shapes(device, args.sweep))
        out.update(scan_shapes(device, sc, smoke.scale_repeat_setup(device)))
        out.update(store_sweep(device))
    if "F" in groups or "G" in groups:
        rsc = smoke.scale_repeat_setup(device)
        if "F" in groups:
            out.update(corr_shapes(device, rsc, torch.Generator(device=device).manual_seed(
                smoke.SEED + 60), args.sweep))
        if "G" in groups:
            out.update(rows_shapes(device, sc, rsc, torch.Generator(device=device).manual_seed(
                smoke.SEED + 70)))
        del rsc
    if "B" not in groups:
        print(json.dumps({"tree": str(tree), "gpu": smoke.gpu_line(), "shapes": out}))
        return
    for r in smoke.TIERS:
        # the flagship fragment at R = 1,024; elsewhere the largest contig
        # that half the tier holds, as chip_smoke.tiers picks it
        genome = sc["tiered"] if r in smoke.TOP_TIERS else sc["shuf"]
        f_a = 7 if r == smoke.F_MAX else smoke.frag_fitting(genome, r)
        scorer = delta.make_delta_scorer(sc["table"], None, r, sobs=sc["sobs"])
        got = delta_shapes(sc, genome, scorer, delta.extract_rows_union, f_a, gen, "100k")
        out.update({k: v for k, v in got.items() if k.startswith("B2") or r == smoke.F_MAX
                    or (k.startswith("B4 100k") and r in smoke.TOP_TIERS)})
        del scorer, got
    for r, genome in zip(smoke.TOP_TIERS, (sc["halves"], sc["truth"])):
        out.update(chains_shapes(sc, genome, r, gen))
    del sc
    rsc = smoke.scale_repeat_setup(device)
    engine = delta_repeats.make_repeat_delta_scorer_v2(rsc["table"], smoke.F_MAX, rsc["sobs"],
                                                       rsc["shuf"].rep)
    out.update(delta_shapes(rsc, rsc["shuf"], engine.plain, delta.extract_rows_each,
                            rsc["n_bins"] + 7, gen, "20k repeat"))
    print(json.dumps({"tree": str(tree), "gpu": smoke.gpu_line(), "shapes": out}))


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except smoke.SmokeFailure as e:
        print(f"kernel_times: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
