"""The step's head and tail (``csrc/step.cu`` ``step_head_kernel``,
``step_tail_kernel``) and the public functions that reach them.

The head is D2's neighbour draw with D1's nuisance proposal beside it, one
launch a step (either part alone too); the tail is D1's Metropolis test
with the dense cycle bodies' l_t select and metrics. On the CPU the public
functions (``core.mcmc.step_head``, ``step_tail``, ``sample_neighbours``,
``nuisance_propose``, ``nuisance_accept``) run their plain versions. Here:

- numpy transcriptions of the kernels' warp designs, read from the
  argument blocks the wrapper fills (``ops.step_cuda.HeadArgs`` /
  ``TailArgs``): the keys ranked by shuffles (n_top <= 32) or lane-strided
  (above), and the entries by (id, index), equal to torch's stable sorts
  (NaN greatest, ties to the lower index); the one-bracket solve (lane l at
  points l and l + 32, two ballots a pass) equal, bit for bit, to the
  four-proposal solve's picked entry for every id_modif; the tail's block
  reduction equal to the plain counts;
- the public functions against ``graal_tpu.core.mcmc`` on shared draws:
  the draw at n_top = 1, m = 80 on a copy-dense table, a blacklisted f_a
  and -inf keys (NaN keys against the plain version only: JAX's top_k
  takes a NaN first, torch's sort last), the proposal at id_modif = 2 and
  under the d_max cap, the tail with non-finite scores, on a chains axis;
  the dense EM cycle's metrics against the JAX cycle's;
- the card branches: the wrapper through a stand-in library (the
  transcriptions, each bumping the counter the wrapper hands it: the
  kernel-kept count equals the calls, and no ``LaunchCount.add`` runs),
  and the EM, tempered and nuisance bodies through a stand-in wrapper: one
  head and one tail a dense step, bit for bit the plain bodies.
"""

import collections
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu.utils.synthetic import (bin_level_matrix, default_params, make_genome,
                                       simulate_contacts)
from graal_tpu_torch import convert
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import step_cuda as sc
from graal_tpu_torch.ops.counts import LaunchCount
from graal_tpu_torch.parallel import tempering as tt
from tests.test_torch_mcmc import RTOL, jax_cycle_draws, port_draws
from tests.test_torch_state import to_port
from tests.test_torch_step_kernels import (_J_PROPOSE, _J_SAMPLE, chain_params, copy_problem,
                                           params_close, t)

F = np.float32
DELTA = 4
CSRC = Path(sc.__file__).resolve().parent.parent / "csrc"


# ---- memory of the argument blocks ---------------------------------------------

def get(ptr, ctype, i):
    return ctype.from_address(ptr + int(i) * ctypes.sizeof(ctype)).value


def put(ptr, ctype, i, value):
    ctype.from_address(ptr + int(i) * ctypes.sizeof(ctype)).value = value


def bump(counter):
    """What block 0's thread 0 does: one more launch on the key's counter."""
    put(counter, ctypes.c_int64, 0, get(counter, ctypes.c_int64, 0) + 1)


def before(x, y):
    """step.cu's `before`: torch's sort order, NaN greatest."""
    return bool(x < y) or (bool(np.isnan(y)) and not bool(np.isnan(x)))


# ---- the head: the draw ---------------------------------------------------------

def shuffle_ranks(keys):
    """n_top <= 32: lane k holds key k and reads key i by __shfl_sync(v, i)."""
    lanes = np.zeros(32, F)
    lanes[:len(keys)] = keys
    ranks = []
    for lane in range(32):
        v = lanes[lane]
        ranks.append(sum(before(lanes[i], v) or (i < lane and not before(v, lanes[i]))
                         for i in range(len(keys))))
    return ranks[:len(keys)]


def strided_ranks(keys):
    """n_top > 32: lane l ranks keys l, l + 32, ... read from shared memory."""
    ranks = [0] * len(keys)
    for lane in range(32):
        for k in range(lane, len(keys), 32):
            ranks[k] = sum(before(keys[i], keys[k]) or (i < k and not before(keys[k], keys[i]))
                           for i in range(len(keys)))
    return ranks


def entry_ranks(skey):
    """The entries' ranks by (key, index), lane-strided."""
    return [sum(w < x or (w == x and i < e) for i, w in enumerate(skey))
            for e, x in enumerate(skey)]


def draw_block(a, c):
    """draw_warp for chain c of the NeighbourArgs ``a``."""
    i32, f32 = ctypes.c_int32, ctypes.c_float
    n_top, mc, m = a.n_top, a.mc, a.m
    fa = get(a.fa, ctypes.c_int64, a.fa_s * c)
    bin_a = get(a.id_d, i32, a.idd_rs * c + a.idd_cs * fa)
    rep_a = get(a.rep, i32, a.rep_rs * c + a.rep_cs * fa) == 1
    pk = [F(get(a.pk, f32, bin_a * n_top + k)) for k in range(n_top)]
    keys = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(n_top):
            g = np.log(pk[k]) if pk[k] > 0 else F(-np.inf)
            u = F(get(a.u, f32, a.u_rs * c + a.u_cs * k))
            keys.append(-(g - np.log(-np.log(u + F(1e-20)) + F(1e-20))))
    ranks = shuffle_ranks(keys) if n_top <= 32 else strided_ranks(keys)
    top = {r: k for k, r in enumerate(ranks) if r < a.d_eff}
    # ranked first: only the m kept entries' rows and flags are read
    sid, sval = [], []
    for e in range(m):
        if e < mc:
            i, ok = get(a.disp, i32, bin_a * mc + e), rep_a
        else:
            k = top[(e - mc) // mc]
            i = get(a.disp, i32, get(a.xk, i32, bin_a * n_top + k) * mc + (e - mc) % mc)
            ok = pk[k] > 0
        sid.append(max(i, 0))
        sval.append(ok and i >= 0 and i != fa
                    and not get(a.blacklist, ctypes.c_ubyte, max(i, 0)))
    skey = [i if ok else 1 << 30 for i, ok in zip(sid, sval)]
    for e, r in enumerate(entry_ranks(skey)):
        put(a.ids, i32, c * m + r, sid[e])
        put(a.valid, ctypes.c_ubyte, c * m + r, int(sval[e]))


# ---- the head: the proposal ---------------------------------------------------

def peval(s, kuhn, lm, slope, d, fact):
    n = (s * lm) / kuhn
    e = np.exp((d - F(2.0)) / (n * n + d))
    return (((fact * F(0.53)) * np.power(kuhn, F(-3.0))) * np.power(n, slope)) * e


def solve_warp(p, slope, fact, v, inv_w, llo, lhi):
    """solve_warp: lane l evaluates points l and l + 32; a pass counts the
    two ballots' bits."""
    frac = [F(j) * inv_w for j in range(64)]
    for _ in range(5):
        above = [bool(peval(np.exp(llo + (lhi - llo) * frac[j]), p[0], p[1], slope, p[4], fact)
                      > v) for j in range(64)]
        ballots = [sum(int(above[h * 32 + lane]) << lane for lane in range(32)) for h in (0, 1)]
        idx = min(max(bin(ballots[0]).count("1") + bin(ballots[1]).count("1") - 1, 0), 62)
        step = (lhi - llo) * inv_w
        llo = llo + F(idx) * step
        lhi = llo + step
    return np.exp((llo + lhi) * F(0.5))


def proposal(p, idm, e, inv_w, llo, lhi, solve=solve_warp):
    """propose_warp's arithmetic: (c1, slope, d_max, fact, v_inter, in
    support before the cap). ``p``: kuhn lm c1 slope d d_max fact v_inter."""
    kuhn, lm, c1, slope, d, d_max, fact, v = p
    with np.errstate(all="ignore"):
        if idm == 2:
            d_max = d_max + e * F(100.0)
            v = peval(d_max, kuhn, lm, slope, d, fact)
            return c1, slope, d_max, fact, v, bool(d_max > 0 and d_max <= 10000)
        if idm == 0:
            fact = fact + e * np.power(F(10.0), np.log10(fact) - F(2.0))
            ok = bool(fact > 0)
        elif idm == 1:
            slope = slope + e * F(0.05)
            c1 = (F(0.53) * np.power(lm / kuhn, slope)) * np.power(kuhn, F(-3.0))
            ok = bool(slope >= -2 and slope <= -0.5)
        else:
            v = v + e * F(0.5)
            ok = bool(v > 0 and v <= 100)
        return c1, slope, solve(p, slope, fact, v, inv_w, llo, lhi), fact, v, ok


def four_proposals(p, idm, e, inv_w, llo, lhi):
    """The plain version's structure: all four proposals built, each
    bracket solved over its 64 points at once, the one ``idm`` names
    picked."""
    kuhn, lm, c1, slope, d, d_max, fact, v = p
    with np.errstate(all="ignore"):
        new_fact = fact + e * np.power(F(10.0), np.log10(fact) - F(2.0))
        new_slope = slope + e * F(0.05)
        c1_slope = (F(0.53) * np.power(lm / kuhn, new_slope)) * np.power(kuhn, F(-3.0))
        new_d_max = d_max + e * F(100.0)
        v_d_max = peval(new_d_max, kuhn, lm, slope, d, fact)
        new_v = v + e * F(0.5)
        fact4, slope4 = [new_fact, fact, fact, fact], [slope, new_slope, slope, slope]
        v4 = [v, v, v_d_max, new_v]
        frac = np.array([F(j) * inv_w for j in range(64)], F)
        solved = []
        for q in range(4):
            lo, hi = llo, lhi
            for _ in range(5):
                xs = np.exp(lo + (hi - lo) * frac)
                above = np.array([peval(x, kuhn, lm, slope4[q], d, fact4[q]) for x in xs]) > v4[q]
                idx = min(max(int(above.sum()) - 1, 0), 62)
                step = (hi - lo) * inv_w
                lo = lo + F(idx) * step
                hi = lo + step
            solved.append(np.exp((lo + hi) * F(0.5)))
        ok4 = [bool(new_fact > 0), bool(-2 <= new_slope <= -0.5),
               bool(0 < new_d_max <= 10000), bool(0 < new_v <= 100)]
    return ([c1, c1_slope, c1, c1][idm], slope4[idm],
            [solved[0], solved[1], new_d_max, solved[3]][idm], fact4[idm], v4[idm], ok4[idm])


def params_row(kuhn, lm, c1, slope, d, d_max, fact, v, log_nfpb):
    """params_row.cuh's row."""
    with np.errstate(all="ignore"):
        log_k3fact = np.log(np.power(kuhn, F(-3.0)) * fact)
        nmax = lm / kuhn
        return [np.log(c1 * fact), slope, d, d_max, nmax, np.log(v), v,
                (log_k3fact + slope * np.log(nmax)) + (d - F(2.0)) / (nmax * nmax + d),
                log_k3fact, log_nfpb]


def propose_block(a, c):
    """propose_warp for chain c of the ProposeArgs ``a``."""
    f32 = ctypes.c_float
    p = [F(get(a.p[k], f32, a.ps[k] * c)) for k in range(8)]
    out = proposal(p, get(a.idm, ctypes.c_int64, a.idm_s * c), F(get(a.eps, f32, a.eps_s * c)),
                   F(a.inv_w), F(a.llo0), F(a.lhi0))
    *vals, ok = out
    if a.has_cap:
        ok = ok and bool(vals[2] <= F(a.cap))
    for k, x in enumerate(vals):
        put(a.out, f32, k * a.C + c, float(x))
    put(a.ok, ctypes.c_ubyte, c, int(ok))
    if a.row:
        c1, slope, d_max, fact, v = vals
        row = params_row(p[0], p[1], c1, slope, p[4], d_max, fact, v, F(get(a.log_nfpb, f32, 0)))
        for k, x in enumerate(row):
            put(a.row, f32, c * 10 + k, float(x))


# ---- the tail ---------------------------------------------------------------------

def block_sums(values, threads=256):
    """The tail's reduction of one chain: thread t sums values t, t + 256,
    ...; a shuffle-down tree a warp; thread 0 adds the warps' partials."""
    part = [sum(values[t_::threads]) for t_ in range(threads)]
    warps = []
    for w in range(threads // 32):
        lanes = part[w * 32:(w + 1) * 32]
        for o in (16, 8, 4, 2, 1):
            lanes = [lanes[lane] + (lanes[lane + o] if lane + o < 32 else lanes[lane])
                     for lane in range(32)]
        warps.append(lanes[0])
    return sum(warps)


def tail_block(a, c):
    """step_tail_kernel for chain c of the TailArgs ``a``."""
    f32, r = ctypes.c_float, a.acc
    if a.pos:
        def field(ptr, rs, cs):
            return [get(ptr, ctypes.c_int32, rs * c + cs * i) for i in range(a.n)]
        pos, act = field(a.pos, a.pos_rs, a.pos_cs), field(a.activ, a.act_rs, a.act_cs)
        lbp = field(a.len_bp, a.len_rs, a.len_cs)
        n_contigs = block_sums([int(x == 0) for x in pos])
        active_bp = block_sums([b if x == 1 else 0 for x, b in zip(act, lbp)])
    l_t = F(get(r.l_t, f32, r.lts * c))
    if a.score:
        s = F(get(a.score, f32, a.sc_s * c))
        if np.isfinite(s):
            l_t = s
    acc = True
    if r.u:
        l_star = F(get(r.l_star, f32, r.lss * c))
        diff = l_star - l_t
        with np.errstate(over="ignore"):
            ratio = np.exp(diff / F(get(r.ft, f32, r.fts * c)) if r.ft else diff * F(r.ft_inv))
        acc = bool(get(r.ok, ctypes.c_ubyte, r.oks * c)) and bool(ratio >= F(get(r.u, f32,
                                                                                r.us * c)))
        for k in range(8):
            src = (r.test[k], r.ts[k]) if acc else (r.par[k], r.ps[k])
            put(r.out, f32, k * r.C + c, get(src[0], f32, src[1] * c))
        if acc:
            l_t = l_star
    put(r.l_out, f32, c, float(l_t))
    put(r.accept, ctypes.c_ubyte, c, int(acc))
    if a.pos:
        put(a.n_contigs, ctypes.c_int64, c, n_contigs)
        put(a.mean_len, f32, c, float(F(active_bp) / F(n_contigs)))


class StandInLibrary:
    """The step library's head and tail entry points run as the
    transcriptions above, each launch counted on the counter the wrapper
    handed it, as block 0's thread 0 does."""

    def __init__(self):
        self.calls = collections.Counter()

    def step_head(self, args, stream):
        a = args._obj
        self.calls["step_head"] += 1
        bump(a.counter)
        assert a.nb.C > 0 or a.pr.C > 0
        for c in range(max(a.nb.C, a.pr.C)):
            if c < a.nb.C:
                draw_block(a.nb, c)
            if c < a.pr.C:
                propose_block(a.pr, c)
        return 0

    def step_tail(self, args, stream):
        a = args._obj
        self.calls["step_tail"] += 1
        bump(a.counter)
        for c in range(a.acc.C):
            tail_block(a, c)
        return 0


def no_torch_add(monkeypatch):
    def refuse(self, device, key=None):
        raise AssertionError(f"a torch add counted {key} beside a self-counting kernel")

    monkeypatch.setattr(LaunchCount, "add", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(sc.StepKernels, "_device", staticmethod(lambda x: x.device))


@pytest.fixture
def library(monkeypatch):
    lib = StandInLibrary()
    no_torch_add(monkeypatch)
    monkeypatch.setattr(sc, "load_library", lambda: lib)
    return lib


# ---- the warp designs -------------------------------------------------------------

@pytest.mark.parametrize("n_top", [1, 7, 10, 32, 33, 45])
def test_key_ranks_equal_the_stable_sort(n_top):
    """The shuffle ranks (n_top <= 32) and the lane-strided ranks (any
    n_top) are the positions of torch's stable ascending sort, NaN greatest
    and ties to the lower index; so are the entries' (key, index) ranks."""
    rng = np.random.default_rng(n_top)
    keys = rng.normal(size=n_top).astype(F)
    keys[rng.random(n_top) < 0.3] = np.inf          # the pk == 0 partners: -g = +inf ties
    keys[rng.random(n_top) < 0.1] = np.nan
    if n_top > 3:
        keys[2] = keys[3]                           # a tie of finite keys
    want = torch.sort(torch.as_tensor(keys), stable=True).indices.tolist()
    for rank_of in ([shuffle_ranks] if n_top <= 32 else []) + [strided_ranks]:
        ranks = rank_of(keys)
        assert sorted(ranks) == list(range(n_top))
        assert [ranks.index(r) for r in range(n_top)] == want
    skey = rng.integers(0, 6, 80).tolist()
    skey = [x if rng.random() < 0.8 else 1 << 30 for x in skey]
    ranks = entry_ranks(skey)
    assert [ranks.index(r) for r in range(80)] == np.argsort(skey, kind="stable").tolist()


def test_one_bracket_equals_the_four_proposals():
    """The head solves only the bracket of the proposal id_modif names
    (none for id 2), lane l at points l and l + 32: bit for bit the entry
    the four-proposal solve picks, for every id_modif, on per-chain
    parameters; and within a few ulps of the plain version on the CPU
    (torch's CPU pow / exp and division differ there from the card's)."""
    rng = np.random.default_rng(5)
    _, tp = chain_params(default_params(fact=5000.0), 12)
    ps = [[F(x) for x in col] for col in zip(*[v.numpy() for v in tp])]
    inv_w, llo, lhi = F(sc.INV_W), F(sc.LLO0), F(sc.LHI0)
    got = []
    for c, p in enumerate(ps):
        for idm in range(4):
            e = F(rng.normal())
            one = proposal(p, idm, e, inv_w, llo, lhi)
            four = four_proposals(p, idm, e, inv_w, llo, lhi)
            assert [np.float32(x).tobytes() for x in one[:5]] == \
                [np.float32(x).tobytes() for x in four[:5]] and one[5] == four[5], (c, idm)
            got.append((idm, e, p, one))
    idm = torch.tensor([g[0] for g in got])
    eps = torch.tensor([g[1] for g in got])
    par = RippeParams(*[torch.tensor([g[2][k] for g in got]) for k in range(8)])
    want, ok, _ = tm.nuisance_propose_plain(idm, eps, par)
    for k, f in enumerate(("c1", "slope", "d_max", "fact", "v_inter")):
        np.testing.assert_allclose([g[3][k] for g in got], getattr(want, f).numpy(), rtol=1e-5)
    assert [g[3][5] for g in got] == ok.tolist()


def test_tail_reduction_counts_exactly():
    """The tail's block reduction (256 threads, warp trees, warp partials)
    of a 6,000-fragment genome equals the plain counts."""
    rng = np.random.default_rng(8)
    pos = (rng.random(6000) < 0.1) * rng.integers(0, 3, 6000)
    act = rng.random(6000) < 0.7
    lbp = rng.integers(1, 40000, 6000)
    assert block_sums([int(x == 0) for x in pos]) == int((pos == 0).sum())
    assert block_sums(np.where(act, lbp, 0).tolist()) == int(lbp[act].sum())


# ---- the public functions against the JAX package -----------------------------------

def draw_case(name):
    """(JAX state, its neighbour table, port state, port table, fragments
    to draw) of an edge case."""
    rng = np.random.default_rng(len(name))
    if name == "copy_dense":           # m = 80 slots: 16 copies of bin 7
        js_, m, id_d, n = copy_problem(rng, {7: 15, 2: 3})
        nb = jm.build_neighbour_table(m, id_d, n, blacklisted=[2, 7, n - 1])
        frags = [7, 2, 3, 5, n - 1] + list(range(n - 18, n))
    else:                              # n_top = 1: two bins
        js_, m, id_d, n = copy_problem(rng, {})
        nb = jm.build_neighbour_table(m[:2, :2], id_d[:2], 2)
        js_ = type(js_)(*[x[:2] for x in js_])._replace(id_d=jnp.arange(2, dtype=jnp.int32))
        frags = [0, 1]
    return js_, nb, to_port(js_), convert.neighbour_table_from_numpy(nb._asdict()), frags


@pytest.mark.parametrize("name", ["copy_dense", "n_top_1"])
def test_head_draw_matches_jax(name):
    """step_head's draw (and sample_neighbours) on shared uniforms against
    JAX's sample_neighbours, one chain a draw on a chains axis: the
    copy-dense table (m = 80, blacklisted f_a among the draws, -inf keys
    on the rows with fewer partners), n_top = 1 (delta cut to 1)."""
    js_, nb, ts, tnb, frags = draw_case(name)
    n_top = nb.pk.shape[1]
    assert (nb.max_copies, n_top) == ((16, 10) if name == "copy_dense" else (1, 1))
    key = jax.random.key(3)
    us, want = [], []
    for f in frags:
        key, sub = jax.random.split(key)
        ids, valid = _J_SAMPLE(sub, jnp.int32(f), js_, nb, delta=min(DELTA, n_top))
        us.append(t(jax.random.uniform(sub, (n_top,))))
        want.append((np.asarray(ids), np.asarray(valid)))
    chains = TState(*[x.expand(len(frags), -1) for x in ts])
    (ids, valid), prop = tm.step_head(torch.stack(us), torch.tensor(frags), chains, tnb, DELTA)
    assert prop is None and ids.shape[1] == (min(DELTA, n_top) + 1) * nb.max_copies
    np.testing.assert_array_equal(ids.numpy(), np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(valid.numpy(), np.stack([w[1] for w in want]))
    assert int(valid.sum()) > 0 and (~valid).any()


def test_head_proposal_matches_jax():
    """step_head's proposal beside a draw, on a chains axis with each
    chain's own parameters: id_modif = 2 chains (no solve) among the others,
    and the d_max cap, against JAX's proposer under jax.vmap."""
    p = default_params(fact=5000.0)
    keys = jax.random.split(jax.random.key(11), 96)
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    idm = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 4))(sub[:, 0]))
    eps = jax.vmap(lambda k: jax.random.normal(k, ()))(sub[:, 1])
    pick = np.concatenate([np.nonzero(idm == 2)[0][:12], np.nonzero(idm != 2)[0][:12]])
    c = len(pick)
    jp, tp = chain_params(p, c)
    want, want_ok, _ = _J_PROPOSE(keys[pick], jp)
    cap = float(np.median(np.asarray(want.d_max)))
    want, want_ok, _ = jax.jit(jax.vmap(jm.make_nuisance_proposer(cap)))(keys[pick], jp)
    state, table = make_genome(n_bins=12, n_contigs=2, subs_per_bin=1, seed=3)
    n = state.n_frags
    nb = convert.neighbour_table_from_numpy(jm.build_neighbour_table(
        np.ones((n, n)) - np.eye(n), np.arange(n), n)._asdict())
    chains = TState(*[x.expand(c, -1) for x in to_port(state)])
    u = torch.rand((c, nb.pk.shape[1]), generator=torch.Generator().manual_seed(1))
    log_nfpb = torch.tensor(F(0.3))
    (ids, _), (test, ok, row) = tm.step_head(
        u, torch.arange(c) % n, chains, nb, DELTA,
        (t(idm[pick]).long(), t(np.asarray(eps)[pick]), tp, cap, log_nfpb))
    assert ids.shape == (c, DELTA + 1) and (idm[pick] == 2).sum() == 12
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert 0 < int(ok.sum()) < c
    params_close(test, want)
    np.testing.assert_array_equal(row.numpy(), tm.params_vector(test, log_nfpb).numpy())


def test_tail_matches_jax():
    """step_tail on a chains axis: l_t <- the score where it is finite
    (-inf and NaN scores keep l_t), then JAX's nuisance_accept under
    jax.vmap on that l_t, per-chain f_t; without a proposal, success true."""
    c = 48
    rng = np.random.default_rng(4)
    jp, tp = chain_params(default_params(fact=5000.0), c)
    jt, tt_ = chain_params(default_params(fact=5300.0), c)
    l_t = (-1000.0 + rng.normal(0, 1, c)).astype(F)
    score = (l_t + rng.normal(0, 1, c)).astype(F)
    score[::7], score[3::11] = -np.inf, np.nan
    l_star = (l_t + rng.normal(0, 1.5, c)).astype(F)
    f_t = np.linspace(0.5, 2.0, c).astype(F)
    ok = rng.random(c) < 0.8
    keys = jax.random.split(jax.random.key(2), c)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys))
    l_sel = jnp.where(jnp.isfinite(score), score, l_t)
    want_p, want_l, want_acc = jax.jit(jax.vmap(jm.nuisance_accept))(
        keys, jt, jp, jnp.asarray(l_star), l_sel, jnp.asarray(f_t), jnp.asarray(ok))
    got = tm.step_tail(t(l_t), t(score), (t(u), tt_, tp, t(l_star), t(f_t), t(ok)))
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want_acc))
    np.testing.assert_array_equal(got.l_t.numpy(), np.asarray(want_l))
    params_close(got.params, want_p)
    assert 0 < int(got.accepted.sum()) < c and got.n_contigs is None
    alone = tm.step_tail(t(l_t), t(score))
    np.testing.assert_array_equal(alone.l_t.numpy(), np.asarray(l_sel))
    assert bool(alone.accepted.all()) and alone.params is None


@pytest.fixture(scope="module")
def cycle_case():
    """A small dense problem and the JAX EM cycle (nuisance on, f_t 0.8)
    run once on it, with the draws it consumed."""
    state, table = make_genome(n_bins=16, n_contigs=3, subs_per_bin=2, seed=2)
    params = default_params(fact=5000.0)
    obs = simulate_contacts(state, table, params, seed=2)
    n = state.n_frags
    nb = jm.build_neighbour_table(bin_level_matrix(obs, table), np.arange(n), n,
                                  blacklisted=[5])
    cur = jm.explode_genome(state)
    l0 = jl.log_likelihood(cur, table, obs, params)
    order = np.random.default_rng(9).permutation(n).astype(np.int32)
    key = jax.random.key(41)
    cycle_j = jm.make_em_cycle(table, obs, nb, DELTA, sample_param=True)
    out_j = cycle_j(cur, key, params, jnp.asarray(order), l0, jnp.float32(0.8))
    t_nb = convert.neighbour_table_from_numpy(nb._asdict())
    draws = port_draws(jax_cycle_draws(key, n, nb.pk.shape[1], tm.n_slots(t_nb, DELTA)))
    return dict(state=to_port(state), start=to_port(cur), l0=torch.tensor(F(l0)), order=order,
                obs=obs, params=convert.params_from_numpy(params._asdict()), nb=t_nb,
                table=convert.table_from_numpy(table._asdict()), draws=draws, out_j=out_j)


def test_dense_cycle_metrics_match_jax(cycle_case):
    """The EM cycle's body as a head, the EM step, the test set's score and
    a tail: every metric series against the JAX cycle's (counts, ops,
    fragments, success and the mean length bit for bit; likelihoods and
    parameters at rtol 1e-5)."""
    p = cycle_case
    cycle = tm.make_em_cycle(p["table"], p["obs"], p["nb"], DELTA, sample_param=True)
    state, params, l_t, m = cycle(p["start"], p["draws"], p["params"],
                                  torch.as_tensor(p["order"]), p["l0"], 0.8)
    mj = p["out_j"][3]
    for f in ("n_contigs", "op_sampled", "id_f_sampled", "id_f_a", "success", "mean_len"):
        np.testing.assert_array_equal(getattr(m, f).numpy(), np.asarray(getattr(mj, f)),
                                      err_msg=f)
    for f in ("likelihood", "fact", "slope", "d_max", "v_inter"):
        np.testing.assert_allclose(getattr(m, f).numpy(), np.asarray(getattr(mj, f)),
                                   rtol=RTOL, err_msg=f)
    assert m.mean_len.dtype == torch.float32 and m.n_contigs.dtype == torch.int64
    assert 0 < int(m.success.sum()) < len(p["order"])


# ---- the card branches ----------------------------------------------------------

def test_wrapper_through_the_stand_in_library(library):
    """Every entry of the wrapper fills the blocks the kernels read: the
    transcriptions run on them give the plain versions' draws, counts and
    selects exactly and the proposals' floats within a few ulps (numpy's
    pow / exp are not torch's); one launch a call, counted by the kernel's
    own counter, no torch add."""
    import chip_smoke
    rng = np.random.default_rng(2)
    step = sc.StepKernels()
    cd_state, _, _, _, cd_nb = chip_smoke.copy_dense_problem(torch.device("cpu"))
    n = cd_state.n_frags
    k = 24
    f_a = torch.as_tensor(rng.integers(0, n, k))
    f_a[:6] = torch.nonzero(cd_state.rep == 1).reshape(-1)[:6]
    u = torch.as_tensor(rng.random((k, cd_nb.pk.shape[1]), dtype=F))
    u[0, 3] = float("nan")                                    # a NaN key: ranked last
    chains = TState(*[x.expand(k, n) for x in cd_state])
    for delta in (DELTA, 40):
        got = step.neighbours(u, f_a, chains.id_d, chains.rep, cd_nb, delta)
        want = tm.sample_neighbours_plain(u, f_a, chains, cd_nb, delta)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = step.neighbours(u[1], f_a[1], cd_state.id_d, cd_state.rep, cd_nb, DELTA)
    want = tm.sample_neighbours_plain(u[1], f_a[1], cd_state, cd_nb, DELTA)
    assert one[0].shape == (80,) and all(torch.equal(a, b) for a, b in zip(one, want))
    # a draw and a proposal in one launch, and a proposal alone
    _, tp = chain_params(default_params(fact=5000.0), k)
    idm = torch.as_tensor(rng.integers(0, 4, k))
    eps = torch.as_tensor(rng.normal(size=k).astype(F))
    nfpb = torch.tensor(F(0.2))
    drawn, (fields, ok, row) = step.step_head((u, f_a, chains.id_d, chains.rep, cd_nb, DELTA),
                                              (idm, eps, tp, 900.0, nfpb))
    test, w_ok, w_row = tm.nuisance_propose_plain(idm, eps, tp, 900.0, nfpb)
    assert all(torch.equal(a, b) for a, b in zip(drawn, tm.sample_neighbours_plain(
        u, f_a, chains, cd_nb, DELTA)))
    for x, f in zip(fields, ("c1", "slope", "d_max", "fact", "v_inter")):
        torch.testing.assert_close(x, getattr(test, f), rtol=1e-5, atol=0, equal_nan=True)
    assert torch.equal(ok, w_ok)
    torch.testing.assert_close(row, w_row, rtol=1e-5, atol=0, equal_nan=True)
    alone = step.nuisance_propose(idm[2], eps[2], RippeParams(*[x[2] for x in tp]))
    assert alone[0][0].dim() == 0 and alone[2] is None
    # the tail: every part, on one genome and on a chains axis
    st = to_port(make_genome(n_bins=40, n_contigs=4, subs_per_bin=1, seed=1)[0])
    st = st._replace(activ=torch.as_tensor((rng.random(st.n_frags) < 0.7).astype(np.int32)))
    ex = tm.explode_genome(st)
    sts = TState(*[torch.stack(xs) for xs in zip(st, ex, st)])
    l_t = torch.tensor([-1000.0, -990.0, -1010.0])
    score = torch.tensor([-999.0, float("-inf"), float("nan")])
    acc = (torch.tensor([0.2, 0.9, 0.5]), RippeParams(*[x[:3] * 1.01 for x in tp]),
           RippeParams(*[x[:3] for x in tp]), torch.tensor([-998.0, -1001.0, -1009.0]), 0.8,
           torch.tensor([True, True, False]))
    for args in ((l_t, score, acc, sts), (l_t, score, None, sts), (l_t, None, acc, None),
                 (l_t[0], score[0], tuple(x[0] if isinstance(x, torch.Tensor) else x
                                          for x in acc[:1]) + (RippeParams(*[x[0] for x in acc[1]]),
                                                               RippeParams(*[x[0] for x in acc[2]]),
                                                               acc[3][0], 0.8, acc[5][0]), st)):
        metrics = None if args[3] is None else (args[3].pos, args[3].activ, args[3].len_bp)
        fields, l_out, accepted, n_contigs, mean_len = step.step_tail(*args[:3], metrics)
        want = tm.step_tail_plain(*args)
        assert torch.equal(l_out, want.l_t) and torch.equal(accepted, want.accepted)
        if args[2] is not None:
            assert all(torch.equal(a, b) for a, b in zip(fields, want.params))
        if args[3] is not None:
            assert torch.equal(n_contigs, want.n_contigs) and torch.equal(mean_len, want.mean_len)
    out = step.nuisance_accept(*acc[:3], acc[3], l_t, acc[4], acc[5])
    want = tm.nuisance_accept_plain(*acc[:3], acc[3], l_t, acc[4], acc[5])
    assert all(torch.equal(a, b) for a, b in zip(out[0], want[0])) and torch.equal(out[2], want[2])
    assert library.calls == {"step_head": 5, "step_tail": 5}
    assert step.launches.by_key() == library.calls


class StandIn(sc.StepKernels):
    """The wrapper with its launches replaced by the plain versions behind
    its own checks, each counted on its key's counter as the kernels count
    themselves (no torch add beside a launch)."""

    def step_head(self, draw=None, propose=None):
        dev = (draw[1] if draw is not None else propose[0]).device
        drawn = proposed = None
        if draw is not None:
            sc.check_neighbours(*draw)
            u, f_a, id_d, rep, nb, delta = draw
            st = TState(*[{"id_d": id_d, "rep": rep}.get(f, id_d) for f in TState._fields])
            drawn = tm.sample_neighbours_plain(u, f_a, st, nb, delta)
        if propose is not None:
            sc.check_propose(*propose)
            test, ok, row = tm.nuisance_propose_plain(*propose)
            proposed = ((test.c1, test.slope, test.d_max, test.fact, test.v_inter), ok, row)
        self.launches.counter(dev, "step_head").add_(1)
        return drawn, proposed

    def step_tail(self, l_t, score=None, accept=None, metrics=None):
        sc.check_tail(l_t, score, accept, metrics)
        state = None if metrics is None else TState(*[
            {"pos": metrics[0], "activ": metrics[1], "len_bp": metrics[2]}.get(f, metrics[0])
            for f in TState._fields])
        out = tm.step_tail_plain(l_t, score, accept, state)
        self.launches.counter(l_t.device, "step_tail").add_(1)
        return (None if out.params is None else tuple(out.params), out.l_t, out.accepted,
                out.n_contigs, out.mean_len)


def route_to_card(monkeypatch):
    """Send the public functions' CPU calls down their card branches, to a
    :class:`StandIn` wrapper."""
    spy = StandIn()
    no_torch_add(monkeypatch)
    monkeypatch.setattr(tm, "STEP", spy)
    monkeypatch.setattr(tm, "step_head", lambda u, f_a, state, nb, delta, nuisance=None:
                        tm._head_on_card(u, torch.as_tensor(f_a).long(), state, nb, delta,
                                         nuisance))
    monkeypatch.setattr(tm, "step_tail", lambda l_t, score=None, accept=None, state=None:
                        tm._tail_on_card(l_t, score, accept, state))
    monkeypatch.setattr(tm, "sample_neighbours", lambda u, f_a, state, nb, delta:
                        tm._neighbours_on_card(u, torch.as_tensor(f_a).long(), state, nb, delta))
    monkeypatch.setattr(tm, "nuisance_propose", tm._propose_on_card)
    monkeypatch.setattr(tm, "nuisance_accept", tm._accept_on_card)
    return spy


def test_bodies_through_the_card_branches(cycle_case, monkeypatch):
    """The dense EM body (with and without the nuisance step), the
    tempered chains' body and the nuisance step alone through the card
    branches: one head and one tail a step (the nuisance step: one of
    each), bit for bit the plain bodies."""
    p = cycle_case
    n = p["state"].n_frags
    order = torch.as_tensor(p["order"])
    chains = TState(*[torch.stack(xs) for xs in zip(p["state"], p["start"], p["start"])])
    ladder = torch.tensor([1.0, 2.0, 4.0])
    orders = torch.stack([order, order.flip(0), order.roll(3)])
    c_draws = tt.draw_chain_inputs(torch.Generator().manual_seed(4), p["nb"], DELTA, 3, (n,))
    nuis_draws = tm.draw_nuisance_inputs(torch.Generator().manual_seed(5))

    def run():
        out = {}
        for sample_param in (True, False):
            cycle = tm.make_em_cycle(p["table"], p["obs"], p["nb"], DELTA,
                                     sample_param=sample_param)
            out[sample_param] = cycle(p["start"], p["draws"], p["params"], order, p["l0"], 0.8)
        out["tempered"] = tt.make_tempered_cycle(p["table"], p["obs"], p["nb"], DELTA)(
            chains, c_draws, p["params"], orders, torch.full((3,), float(p["l0"])), ladder)
        out["nuisance"] = tm.make_nuisance_step(p["table"], p["obs"])(
            p["state"], nuis_draws, p["params"], p["l0"], 1.0)
        return out

    want = run()
    spy = route_to_card(monkeypatch)
    got = run()
    # n steps of each EM cycle and of the tempered one (all chains a launch), one nuisance step
    assert spy.launches.by_key() == {"step_head": 3 * n + 1, "step_tail": 3 * n + 1}

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return all(same(x, y) for x, y in zip(a, b))

    for k in want:
        assert same(got[k], want[k]), k


def test_old_kernels_and_adds_are_gone():
    """step.cu defines the head and the tail in place of the three old
    kernels, and the wrapper adds nothing beside a launch."""
    cu = (CSRC / "step.cu").read_text()
    for name in ("nuisance_propose_kernel", "nuisance_accept_kernel", "neighbours_kernel"):
        assert name not in cu
    assert "step_head_kernel" in cu and "step_tail_kernel" in cu
    src = Path(sc.__file__).read_text()
    assert ".add(" not in src and "launches.add" not in src
    assert sc.KINDS == ("step_head", "step_tail", "select_dense", "select_delta")


def test_ctypes_mirrors_follow_the_source():
    """HeadArgs / TailArgs hold the fields of step.cu's structs in order."""
    cu = (CSRC / "step.cu").read_text()
    for cls, name in ((sc.HeadArgs, "HeadArgs"), (sc.TailArgs, "TailArgs"),
                      (sc.NeighbourArgs, "NeighbourArgs")):
        body = cu[cu.index(f"struct {name} {{"):]
        body = body[:body.index("};")]
        at = [re.search(rf"[ *]{f}\s*[;,\[]", body).start() for f, _ in cls._fields_]
        assert at == sorted(at), name


def _bad_tail(name):
    z = torch.zeros(3)
    par = RippeParams(*[torch.ones(3) for _ in RippeParams._fields])
    acc = (z, par, par, z, 1.0, torch.ones(3, dtype=torch.bool))
    pos = torch.zeros((3, 5), dtype=torch.int32)
    return {
        "l_t": ([1.0], None, None, None),
        "score_shape": (z, torch.zeros(4), None, None),
        "score_dtype": (z, z.double(), None, None),
        "accept_len": (z, None, acc[:5], None),
        "accept_dtype": (z, None, acc[:3] + (z.double(),) + acc[4:], None),
        "metrics_dtype": (z, None, None, (pos.long(), pos, pos)),
        "metrics_shape": (z, None, None, (pos, pos[:, :4], pos)),
        "metrics_chains": (z, None, None, (pos[:2], pos[:2], pos[:2])),
        "metrics_len": (z, None, None, (pos, pos)),
    }[name]


@pytest.mark.parametrize("name", ["l_t", "score_shape", "score_dtype", "accept_len",
                                  "accept_dtype", "metrics_dtype", "metrics_shape",
                                  "metrics_chains", "metrics_len"])
def test_check_tail_refuses(name):
    with pytest.raises(ValueError):
        sc.check_tail(*_bad_tail(name))


def test_check_tail_accepts_what_the_kernel_takes():
    par = RippeParams(*[torch.ones(()) for _ in RippeParams._fields])
    pos = torch.zeros((4, 7), dtype=torch.int32)
    c, shape, shapes, f = sc.check_tail(torch.zeros(4), torch.zeros(4),
                                        (torch.zeros(4), par, par, torch.zeros(4), 0.5,
                                         torch.ones(4, dtype=torch.bool)), (pos, pos, pos))
    assert c == 4 and tuple(shape) == (4,) and all(tuple(s) == (4,) for s in shapes)
    assert f["metrics"][0][1:] == (7, 1) and f["ft"][0] is None
    c, shape, shapes, f = sc.check_tail(torch.zeros(()), None, None, (pos[0], pos[0], pos[0]))
    assert c == 1 and tuple(shape) == () and shapes is None and f["metrics"][0][1:] == (0, 1)
