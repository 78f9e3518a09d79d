"""Parity of the copy-summing dense scorer (graal_tpu_torch.ops.repeat_cuda,
kernel B3's plain version) with the JAX package, on the CPU.

The repeat problem is tests/test_pallas.py's ``_repeat_problem`` (30 bins
x 2 subs, bins 3 and 11 duplicated once). Tolerances are the JAX tests':
- against ``make_repeat_pallas_scorer`` in the Pallas interpreter and
  against the jnp ``log_likelihood``: rtol 5e-4, atol 0.5
  (tests/test_pallas.py:149,161);
- against the f64 loop oracle ``log_likelihood_ref``: rtol 5e-5, atol 0.5.
Cases: the genome as it is, one copy deactivated, the exploded genome, and
a circularised contig holding a repeat copy (the original of bin 3).

The CUDA kernel's own cell algebra (csrc/ll_repeat.cu) is transcribed here
in torch (:func:`kernel_cells`): single-copy cells in log space, trans
cells as a product of row and column factors, inactive copies (a = 0)
adding 0 by a branch, cells of duplicated subs summed in linear space in
slot order. On a table with 1-, 2- and 3-copy subs it must agree with the
plain version and with the Pallas interpreter to rtol 1e-5: the log- and
linear-space clamps max(raw, log v) and max(exp(raw), v) agree to rounding
only, and the Pallas kernel sums f32 tiles (it is within 3e-6 of the plain
version on these problems).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.core import ops as jops
from graal_tpu.core.state import GenomeState as JState
from graal_tpu.ops import likelihood_pallas as lp
from graal_tpu_torch import convert
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import likelihood_cuda as lc
from graal_tpu_torch.ops import repeat_cuda as rc
from graal_tpu_torch.ops.mini_grid_cuda import log_cis_plain
from tests.test_pallas import _repeat_problem
from tests.test_torch_state import to_port

RTOL, ATOL = 5e-4, 0.5
REF_RTOL, REF_ATOL = 5e-5, 0.5
CASES = ("as_is", "deactivated", "exploded", "circular")


def _variants(state):
    n = state.n_frags
    s = state.to_numpy()
    deact = state._replace(activ=jnp.asarray(np.where(np.arange(n) == n - 1, 0, s["activ"]),
                                             jnp.int32))
    members = np.nonzero(s["id_c"] == s["id_c"][3])[0]          # holds bin 3 (rep == 1)
    order = members[np.argsort(s["pos"][members])]
    circ = jops.paste(state, int(order[0]), int(order[-1]), int(np.max(s["id_c"])))
    assert int(np.asarray(circ.circ)[3]) == 1 and int(s["rep"][3]) == 1
    return dict(as_is=state, deactivated=deact, exploded=jm.explode_genome(state),
                circular=circ)


@pytest.fixture(scope="module")
def problem():
    state, table, params, obs = _repeat_problem()
    variants = _variants(state)
    batch = JState(*[jnp.stack(xs) for xs in zip(*[variants[c] for c in CASES])])
    pallas = np.asarray(lp.make_repeat_pallas_scorer(table, obs, interpret=True)(batch, params))
    tt = convert.table_from_numpy(table._asdict())
    tp = convert.params_from_numpy(params._asdict())
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    tbatch = TState(*[torch.stack(xs) for xs in zip(*[to_port(variants[c]) for c in CASES])])
    return dict(state=state, table=table, params=params, obs=obs, variants=variants,
                pallas=dict(zip(CASES, pallas)), tt=tt, tp=tp, scorer=scorer,
                tbatch=tbatch, got=dict(zip(CASES, scorer(tbatch, tp).numpy())))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_and_jnp(problem, case):
    p = problem
    got = p["got"][case]
    want = float(jl.log_likelihood(p["variants"][case], p["table"], p["obs"], p["params"]))
    np.testing.assert_allclose(got, p["pallas"][case], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_f64_oracle(problem, case):
    p = problem
    ref = jl.log_likelihood_ref(p["variants"][case], p["table"], p["obs"], p["params"])
    np.testing.assert_allclose(p["got"][case], ref, rtol=REF_RTOL, atol=REF_ATOL)


def test_dispatch_through_make_dense_scorer(problem):
    p = problem
    scorer = p["scorer"]
    assert isinstance(scorer, rc.RepeatScorer)
    assert scorer.n_launches == 0                      # the CPU path never launches
    assert p["tt"].has_repeats and scorer.k == p["tt"].n_subs > scorer.s
    with pytest.raises(ValueError):                    # the kernel launch is CUDA-only
        scorer.launch(*scorer.sub_vectors(p["tbatch"]),
                      lc.params_vector(p["tp"], scorer.log_nfpb))
    with pytest.raises(ValueError):                    # the repeat-free scorer refuses
        lc.DenseScorer(p["tt"], p["obs"], "cpu")
    # a copy-free table still gets the repeat-free scorer
    from graal_tpu_torch.core.subfrags import trivial_table
    assert isinstance(lc.make_dense_scorer(trivial_table(np.full(6, 3000.0)),
                                           np.zeros((6, 6), np.float32), "cpu"),
                      lc.DenseScorer)


def test_batch_and_chunk_invariance(problem):
    p = problem
    scorer, batch = p["scorer"], p["tbatch"]
    vecs = scorer.sub_vectors(batch)
    pvec = lc.params_vector(p["tp"], scorer.log_nfpb)
    whole = scorer.plain(*vecs, pvec)
    chunked = scorer.plain(*vecs, pvec, max_cells=scorer.s * scorer.s)   # one genome a chunk
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())
    for i in range(batch.pos.shape[0]):
        alone = scorer(TState(*[x[i:i + 1] for x in batch]), p["tp"])
        assert alone.item() == whole[i].item()


def test_log_factorial_plane_bit_identical():
    rng = np.random.default_rng(0)
    ob = rng.poisson(6.0, (50, 50)).astype(np.float32)
    ob[0, :40] = np.arange(40)                         # every branch, 0 to 39
    np.testing.assert_array_equal(rc.log_factorial_np(ob), lp._log_factorial_np(ob))


def test_copy_vectors_follow_copy_order(problem):
    """The copy-order vectors put each data sub's copies at its CSR range,
    in row order, so the kernel's per-block runs are contiguous."""
    p = problem
    scorer = p["scorer"]
    data_id = p["tt"].data_id.numpy()
    start = scorer.copy_start.numpy()
    order = np.argsort(data_id, kind="stable")
    for s_ in (3 * 2, 3 * 2 + 1, 0, 59):
        rows = order[start[s_]:start[s_ + 1]]
        assert np.all(data_id[rows] == s_) and np.all(np.diff(rows) > 0)
    assert len(order[start[6]:start[7]]) == 2              # a duplicated sub: two copies
    assert scorer.max_blk == p["tt"].n_subs                 # one 64-sub block holds all


KERNEL_RTOL = 1e-5
MIXED_CASES = ("as_is", "deactivated_3copy", "exploded", "circular", "inactive_single")


def _mixed_problem(seed=9, n_bins=30):
    """tests/test_pallas.py's repeat problem with bin 3 duplicated twice
    (data subs with 3 copy rows) and bin 11 once (2 copy rows)."""
    from graal_tpu.core.subfrags import build_sub_frag_table
    from graal_tpu.pipeline import extend_with_repeats
    from graal_tpu.utils.synthetic import default_params, make_genome, simulate_contacts

    state, table = make_genome(n_bins=n_bins, n_contigs=3, subs_per_bin=2, seed=seed)
    soa = {f: np.asarray(getattr(state, f)) for f in state._fields}
    soa["n_accu"] = np.ones(n_bins, np.int64)
    soa = extend_with_repeats(soa, [(3, 2), (11, 1)])
    state = JState.from_soa(soa)
    k = 2 * n_bins
    sub_ids = np.zeros((n_bins, 4), np.int64)
    sub_ids[:, 0], sub_ids[:, 1], sub_ids[:, 3] = np.arange(0, k, 2), np.arange(1, k, 2), 2
    sub_len = np.zeros((n_bins, 3))
    sub_len[:, :2] = np.asarray(table.len_kb).reshape(n_bins, 2)
    sub_acc = np.zeros((n_bins, 3))
    sub_acc[:, :2] = 1.0
    table = build_sub_frag_table(sub_ids, sub_len, sub_acc, soa["id_d"])
    params = default_params(fact=5000.0)
    return state, table, params, simulate_contacts(state, table, params, seed=seed)


def _mixed_variants(state, n_bins=30):
    n = state.n_frags
    s = state.to_numpy()

    def without(f):
        return state._replace(activ=jnp.asarray(np.where(np.arange(n) == f, 0, s["activ"]),
                                                jnp.int32))

    members = np.nonzero(s["id_c"] == s["id_c"][3])[0]          # holds bin 3's original
    order = members[np.argsort(s["pos"][members])]
    circ = jops.paste(state, int(order[0]), int(order[-1]), int(np.max(s["id_c"])))
    assert int(np.asarray(circ.circ)[3]) == 1
    # n_bins is the first extra copy of bin 3; fragment 20 is a bin of one copy
    return dict(as_is=state, deactivated_3copy=without(n_bins), exploded=jm.explode_genome(state),
                circular=circ, inactive_single=without(20))


def log_cis_raw(s, circ_row, stot, pvec):
    """RippeCell::log_cis_raw: the unclamped log of the same-contig model."""
    (log_c1fact, slope, d, _, lmk, log_v, _, log_norm_circ, log_k3fact, _) = pvec.unbind()
    safe_s = torch.clamp_min(s, 1e-9)
    n_lin = safe_s * lmk
    log_lin = log_c1fact + slope * torch.log(safe_s) + (d - 2.0) / (n_lin * n_lin + d)
    in_range = (s > 0.0) & (s < pvec[3])
    n_circ = lmk * safe_s * torch.clamp_min(stot - s, 1e-9) / torch.clamp_min(stot, 1e-9)
    log_val_circ = log_k3fact + slope * torch.log(n_circ) + (d - 2.0) / (n_circ * n_circ + d)
    log_norm_lin = torch.where(in_range, torch.maximum(log_lin, log_v), log_v)
    return torch.where(circ_row, log_val_circ + log_norm_lin - log_norm_circ, log_lin), in_range


def kernel_cells(scorer, vecs, pvec):
    """ll_repeat.cu's per-cell algebra in torch, over the whole data grid
    of each candidate; (B,) f32 scores, each summed in f64.

    Per copy row the kernel stages cst (the contig length on a circular
    row, else -1), la = log a (a > 0) and ap = a / nfpb. A cell whose two
    data subs have one copy each is a log-space cell: 0 if either copy is
    inactive, else log E = (same contig ? log_cis : log v) + (la_u + la_v
    - log nfpb), E = exp(log E) on a same-contig pair and (v ap_u) a_v on a
    trans pair. Any other cell sums (same ? cis ap_u : v ap_u) a_v over its
    active copy pairs in slot order, then takes the pmf of the sum."""
    mid, idc, circ, stot, a = vecs
    log_v, v_inter, log_nfpb = pvec[5], pvec[6], pvec[9]
    slots, slot_ok = scorer.slots, scorer.slot_ok
    s_dim = slots.shape[0]
    n_cp = slot_ok.sum(1)
    single = (n_cp[:, None] == 1) & (n_cp[None, :] == 1)
    obs, lf = scorer.obs, scorer.lf
    per_slot = []
    for q in range(slots.shape[1]):
        rows = slots[:, q]
        aq = torch.where(slot_ok[:, q], a[:, rows], 0.0)
        per_slot.append(dict(mid=mid[:, rows], idc=idc[:, rows], a=aq, ap=aq / scorer.nfpb,
                             cst=torch.where(circ[:, rows] == 1.0, stot[:, rows], -1.0),
                             la=torch.where(aq > 0, torch.log(torch.where(aq > 0, aq, 1.0)),
                                            0.0)))

    def pair(u, v):
        s = (u["mid"][:, :, None] - v["mid"][:, None, :]).abs()
        cst = u["cst"][:, :, None].expand_as(s)
        raw, in_range = log_cis_raw(s, cst >= 0.0, cst, pvec)
        return u["idc"][:, :, None] == v["idc"][:, None, :], raw, in_range

    # log-space cells (slot 0 is the only copy of a single-copy sub)
    u, v = per_slot[0], per_slot[0]
    same, raw, in_range = pair(u, v)
    log_cis = torch.where(in_range, torch.maximum(raw, log_v), log_v)
    la_pair = (u["la"][:, :, None] + v["la"][:, None, :]) - log_nfpb
    log_e = torch.where(same, log_cis + la_pair, log_v + la_pair)
    e = torch.where(same, torch.exp(log_e), (v_inter * u["ap"])[:, :, None] * v["a"][:, None, :])
    active = (u["ap"][:, :, None] > 0) & (v["a"][:, None, :] > 0)
    pmf_log = torch.where(active, torch.where(obs > 0, obs * log_e - e - lf, -e), 0.0)
    # linear-space cells
    e_tot = torch.zeros_like(pmf_log)
    for u in per_slot:
        for v in per_slot:
            same, raw, in_range = pair(u, v)
            cis = torch.where(in_range, torch.maximum(torch.exp(raw), v_inter), v_inter)
            f = torch.where(same, cis * u["ap"][:, :, None], (v_inter * u["ap"])[:, :, None])
            ok = (u["ap"][:, :, None] > 0) & (v["a"][:, None, :] > 0)
            e_tot = e_tot + torch.where(ok, f * v["a"][:, None, :], 0.0)
    log_tot = torch.log(torch.where(e_tot > 0, e_tot, 1.0))
    pmf_lin = torch.where(e_tot > 0, torch.where(obs > 0, obs * log_tot - e_tot - lf, -e_tot),
                          0.0)
    upper = torch.ones((s_dim, s_dim), dtype=torch.bool).triu(1)
    pmf = torch.where(upper, torch.where(single, pmf_log, pmf_lin), 0.0)
    return pmf.sum(dim=(1, 2), dtype=torch.float64).float()


@pytest.fixture(scope="module")
def mixed():
    state, table, params, obs = _mixed_problem()
    variants = _mixed_variants(state)
    batch = JState(*[jnp.stack(xs) for xs in zip(*[variants[c] for c in MIXED_CASES])])
    pallas = np.asarray(lp.make_repeat_pallas_scorer(table, obs, interpret=True)(batch, params))
    tt = convert.table_from_numpy(table._asdict())
    tp = convert.params_from_numpy(params._asdict())
    scorer = lc.make_dense_scorer(tt, obs, "cpu")
    tbatch = TState(*[torch.stack(xs) for xs in zip(*[to_port(variants[c]) for c in MIXED_CASES])])
    vecs = scorer.sub_vectors(tbatch)
    pvec = lc.params_vector(tp, scorer.log_nfpb)
    return dict(scorer=scorer, vecs=vecs, pvec=pvec, pallas=pallas,
                plain=scorer.plain(*vecs, pvec).numpy(),
                kernel=kernel_cells(scorer, vecs, pvec).numpy())


def test_mixed_table_has_one_two_and_three_copy_subs(mixed):
    counts = np.bincount(np.diff(mixed["scorer"].copy_start.numpy()))
    assert counts[1] > 0 and counts[2] == 2 and counts[3] == 2     # bin 11 and bin 3, 2 subs each
    a = mixed["vecs"][4]
    assert bool((a == 0).any(dim=1)[MIXED_CASES.index("deactivated_3copy")])
    assert bool((a == 0).any(dim=1)[MIXED_CASES.index("inactive_single")])


@pytest.mark.parametrize("case", MIXED_CASES)
def test_kernel_cell_algebra_matches_plain_and_pallas(mixed, case):
    i = MIXED_CASES.index(case)
    got = mixed["kernel"][i]
    np.testing.assert_allclose(got, mixed["plain"][i], rtol=KERNEL_RTOL)
    np.testing.assert_allclose(got, mixed["pallas"][i], rtol=KERNEL_RTOL)


def test_plain_matches_pallas_with_three_copies(mixed):
    np.testing.assert_allclose(mixed["plain"], mixed["pallas"], rtol=KERNEL_RTOL)


def test_kernel_cell_algebra_on_the_two_copy_problem(problem):
    p = problem
    vecs = p["scorer"].sub_vectors(p["tbatch"])
    pvec = lc.params_vector(p["tp"], p["scorer"].log_nfpb)
    got = kernel_cells(p["scorer"], vecs, pvec).numpy()
    np.testing.assert_allclose(got, [p["got"][c] for c in CASES], rtol=KERNEL_RTOL)
    np.testing.assert_allclose(got, [p["pallas"][c] for c in CASES], rtol=KERNEL_RTOL)


def test_launch_geometry_of_the_copy_blocks(mixed):
    """The kernel's shared memory is sized by the largest copy run of an
    item's 32 rows and of its 64 columns."""
    sc = mixed["scorer"]
    start = sc.copy_start.numpy()
    assert sc.max_blk == start[min(64, sc.s)] - start[0]
    assert sc.max_hblk == max(start[min(e + 32, sc.s)] - start[e] for e in range(0, sc.s, 32))
    assert rc.block_max(start, sc.s, 1) == 3
