"""The dense scorers' sub-fragment vectors and parameter row (kernel H1,
graal_tpu_torch/csrc/vectors.cu, wrapper ops/vectors_cuda.py) on the CPU.

A CUDA kernel cannot run here, so H1's function is held through a numpy
transcription that reads the wrapper's own argument block (pointers and
strides, as the kernel does), walks its grid block by block (a chunk of
sub rows for a group of G genomes, the shape the wrapper's ``plan`` picks)
and rounds in the kernel's order:

- bit for bit against the plain vectors (``CopyRowScorer.geometry``,
  ``RepeatScorer.vectors_plain``) on random genomes with circular contigs,
  deactivated copies and both orientations, at B = 1 as the nuisance
  call's ``x[None]`` view and with fields at other strides, dividing by
  1,000 as torch does on the CPU; and, multiplying by the f32 reciprocal
  as the kernel and torch on the card do, against the plain version's
  operations in that form;
- the parameter row equal to the nuisance proposal's (kernel D1's), whose
  code H1 shares (``csrc/params_row.cuh``);
- the layout at B = 1, 65, 130 (with ``a``) and 260, on broadcast
  ``x[None]`` views and (B, n) views at other strides, under the plan and
  every group size: every output written once, equal to the plain vectors
  and row and to the JAX package's own ``sub_vectors`` / ``copy_vectors``
  / ``params_vector`` (taken from its Pallas scorers' closures);
- the plain scorers fed through the card's dispatch (the wrapper itself,
  launching into a stand-in library that runs the transcription and counts
  the launch on the counter the wrapper hands it, as the kernel does)
  against the JAX package's ``make_pallas_scorer`` /
  ``make_repeat_pallas_scorer`` in the Pallas interpreter at the existing
  tolerances; no torch add counts a launch;
- the wrapper's checks, its refusal of CPU tensors, and the ctypes mirror
  of the argument block parsed from the .cu.
"""

import ctypes
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.core.state import GenomeState as JState
from graal_tpu.ops import likelihood_pallas as lp
from graal_tpu.utils.synthetic import default_params, make_genome, simulate_contacts
from graal_tpu_torch import convert
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import likelihood_cuda as lc
from graal_tpu_torch.ops import vectors_cuda as vc
from graal_tpu_torch.ops.counts import LaunchCount
from tests.test_pallas import _repeat_problem
from tests.test_torch_likelihood import SCORER_RTOL, stack_port, variants
from tests.test_torch_repeat_scorer import ATOL as REPEAT_ATOL
from tests.test_torch_repeat_scorer import RTOL as REPEAT_RTOL
from tests.test_torch_repeat_scorer import _variants as repeat_variants
from tests.test_torch_state import to_port

CSRC = Path(__file__).resolve().parents[1] / "graal_tpu_torch" / "csrc"


def _arr(ptr, dtype, count):
    """A numpy view of ``count`` elements at a raw address."""
    ct = np.ctypeslib.as_ctypes_type(np.dtype(dtype))
    return np.ctypeslib.as_array((ct * count).from_address(ptr))


def h1_transcribed(a: vc.VectorsArgs, reciprocal: bool):
    """H1 in numpy from its argument block, as its blocks run it: block (x,
    y) takes sub rows [x * threads, (x + 1) * threads) of genomes [y * G,
    (y + 1) * G) (``threads``, ``group`` from the block, the grid as the C
    entry point makes it); a thread loads owner[k] and the table's vectors
    at k once, then every genome's fields at owner[k] at their strides,
    then stores each genome's outputs, in the kernel's operation order
    (int32 -> f32 rounding to nearest, then the scale by 1 / 1000, then
    (start_kb + w) + len_half). ``reciprocal``: scale by the block's f32
    reciprocal (the kernel, torch on the card) instead of dividing by 1,000
    (torch on the CPU). Writes the block's outputs; holds the grid to write
    every output exactly once. Returns the grid."""
    b_n, k_n, threads, group = a.B, a.K, a.threads, a.group
    assert threads % 32 == 0 and 32 <= threads <= 256 and group in vc.GROUPS
    grid = (-(-k_n // threads), -(-b_n // group))
    owner = _arr(a.owner, np.int32, k_n).astype(np.int64)
    prefix, suffix, len_half = (_arr(p, np.float32, k_n) for p in (a.prefix, a.suffix,
                                                                    a.len_half))
    accu = _arr(a.accu, np.float32, k_n) if a.a else None
    n_read = len(vc.READ) if a.a else len(vc.READ) - 1
    fields = []
    for i in range(n_read):
        last = a.st_bs[i] * (b_n - 1) + a.st_is[i] * int(owner.max())
        fields.append(_arr(a.st[i], np.int32, last + 1))
    outs = dict(mid=_arr(a.mid, np.float32, b_n * k_n), idc=_arr(a.idc, np.int32, b_n * k_n),
                circ=_arr(a.circ, np.float32, b_n * k_n), stot=_arr(a.stot, np.float32, b_n * k_n))
    if a.a:
        outs["a"] = _arr(a.a, np.float32, b_n * k_n)
    written = np.zeros(b_n * k_n, np.int64)

    def kb(x):
        x = x.astype(np.float32)
        return x * np.float32(a.inv_kb) if reciprocal else x / np.float32(1000.0)

    for y in range(grid[1]):
        b = y * group + np.arange(group)
        b = b[b < b_n][:, None]
        for x in range(grid[0]):
            k = x * threads + np.arange(threads)
            k = k[k < k_n]
            f = owner[k][None, :]
            v = [fields[i][a.st_bs[i] * b + a.st_is[i] * f] for i in range(n_read)]
            e = (b * k_n + k[None, :]).reshape(-1)
            w = np.where(v[1] == 1, prefix[k][None, :], suffix[k][None, :])
            outs["mid"][e] = ((kb(v[0]) + w) + len_half[k][None, :]).reshape(-1)
            outs["idc"][e] = v[2].reshape(-1)
            outs["circ"][e] = v[3].astype(np.float32).reshape(-1)
            outs["stot"][e] = kb(v[4]).reshape(-1)
            if a.a:
                outs["a"][e] = np.where(v[5] == 1, accu[k][None, :], np.float32(0.0)).reshape(-1)
            written[e] += 1
    assert (written == 1).all()
    return grid


def params_row_transcribed(p, log_nfpb):
    """``write_params_row`` (csrc/params_row.cuh) in numpy f32."""
    f = {k: np.float32(float(v)) for k, v in p._asdict().items()}
    log_k3fact = np.log(np.float32(np.power(f["kuhn"], np.float32(-3.0))) * f["fact"])
    nmax = f["lm"] / f["kuhn"]
    norm = (log_k3fact + f["slope"] * np.log(nmax)) + (f["d"] - np.float32(2.0)) \
        / (nmax * nmax + f["d"])
    return np.array([np.log(f["c1"] * f["fact"]), f["slope"], f["d"], f["d_max"], nmax,
                     np.log(f["v_inter"]), f["v_inter"], norm, log_k3fact,
                     np.float32(float(log_nfpb))], np.float32)


def bump(counter):
    """What block (0, 0)'s thread 0 does: one more launch on the key's
    counter."""
    c = ctypes.c_int64.from_address(counter)
    c.value += 1


def row_of(a: vc.VectorsArgs):
    """The parameter row the block asks for, as the plain version makes it
    from the parameters it points to (the kernel's code is
    params_row.cuh's, which D1 shares: see
    :func:`test_parameter_row_is_the_nuisance_proposals`)."""
    par = RippeParams(*[torch.tensor(_arr(p, np.float32, 1)[0]) for p in a.par])
    return lc.params_vector(par, torch.tensor(_arr(a.log_nfpb, np.float32, 1)[0]))


class StandInLibrary:
    """The vector library's entry point run as :func:`h1_transcribed`
    (dividing by 1,000, as torch on the CPU), the row as the plain
    version's, each launch counted on the counter the wrapper handed it, as
    block (0, 0)'s thread 0 does."""

    def __init__(self):
        self.calls = []

    def vectors(self, ref, stream):
        a = ref._obj
        assert a.counter, "a launch without its counter"
        bump(a.counter)
        h1_transcribed(a, reciprocal=False)
        if a.row:
            _arr(a.row, np.float32, vc.N_ROW)[:] = row_of(a).numpy()
        self.calls.append((a.B, bool(a.row)))
        return 0


class StandIn(vc.VectorKernels):
    """The wrapper itself (its checks, plan, argument block and counter, on
    CPU tensors), launching into a :class:`StandInLibrary`."""

    def __init__(self, lib):
        super().__init__()
        self.lib = lib

    @property
    def calls(self):
        return self.lib.calls

    @staticmethod
    def _card(dev):
        pass


def no_torch_add(monkeypatch):
    def refuse(self, device, key=None):
        raise AssertionError(f"a torch add counted {key} beside a self-counting kernel")

    monkeypatch.setattr(LaunchCount, "add", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))


def route_to_card(monkeypatch, scorer):
    """Send ``scorer``'s vectors through its card branch and the wrapper
    into a stand-in library; no torch add may count a launch."""
    lib = StandInLibrary()
    spy = StandIn(lib)
    no_torch_add(monkeypatch)
    monkeypatch.setattr(vc, "load_library", lambda: lib)
    monkeypatch.setattr(lc, "VECTORS", spy)
    monkeypatch.setattr(type(scorer), "vectors", type(scorer)._vectors_on_card)
    return spy


def random_states(state: TState, b: int, seed: int) -> TState:
    """``b`` genomes from ``state``: every field of each row redrawn where
    H1 reads it (start_bp, ori, circ, activ, l_cont_bp) so that both
    orientations, circular contigs and inactive fragments occur."""
    rng = np.random.default_rng(seed)
    n = state.n_frags

    def ints(lo, hi):
        return torch.as_tensor(rng.integers(lo, hi, (b, n)).astype(np.int32))

    base = TState(*[x[None].expand(b, -1).clone() for x in state])
    return base._replace(start_bp=ints(0, 3_000_000), ori=torch.where(ints(0, 2) == 1, 1, -1).int(),
                         circ=ints(0, 2), activ=ints(0, 2), l_cont_bp=ints(1, 4_000_000))


@pytest.fixture(scope="module")
def scorers():
    rstate, rtable, rparams, robs = _repeat_problem()
    state, table = make_genome(n_bins=24, n_contigs=3, subs_per_bin=3, seed=5)
    params = default_params(fact=5000.0)
    obs = simulate_contacts(state, table, params, seed=5)
    return dict(
        dense=(lc.make_dense_scorer(convert.table_from_numpy(table._asdict()), obs, "cpu"),
               to_port(state)),
        repeat=(lc.make_dense_scorer(convert.table_from_numpy(rtable._asdict()), robs, "cpu"),
                to_port(rstate)),
        params=convert.params_from_numpy(rparams._asdict()),
        jax_dense=(state, table, params, obs), jax_repeat=(rstate, rtable, rparams, robs))


def layouts(states: TState):
    """The batch, its first genome as an ``x[None]`` view (the nuisance
    call's), and the batch with every field a column-major view."""
    one = TState(*[x[0] for x in states])
    yield "batch", states
    yield "x[None]", TState(*[x[None] for x in one])
    yield "column-major", TState(*[x.T.contiguous().T for x in states])


@pytest.mark.parametrize("kind", ("dense", "repeat"))
def test_transcription_matches_plain_vectors(scorers, kind):
    """H1's index and rounding order, bit for bit the plain vectors (the
    ``a`` column on the repeat table), in both scale forms."""
    scorer, state = scorers[kind]
    assert (len(scorer.VECTORS) == 5) == (kind == "repeat")
    kb = torch.tensor(vc.INV_KB)
    for seed in range(3):
        batch = random_states(state, 9, seed)
        assert int(batch.circ.sum()) > 0 and int((batch.ori == -1).sum()) > 0
        for name, st in layouts(batch):
            a, keep, (vecs, row) = vc.vectors_args(st, scorer.sub_rows)
            assert row is None and all(v.is_contiguous() for v in vecs)
            h1_transcribed(a, reciprocal=False)
            want = scorer.vectors_plain(st)
            assert len(vecs) == len(want)
            for label, g, w in zip(scorer.VECTORS, vecs, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (name, label)
            h1_transcribed(a, reciprocal=True)
            own = scorer.owner
            start_kb = st.start_bp[:, own].float() * kb
            mid = start_kb + torch.where(st.ori[:, own] == 1, scorer.prefix, scorer.suffix) \
                + scorer.len_half
            assert torch.equal(vecs[0], mid) and torch.equal(vecs[1], want[1])
            assert torch.equal(vecs[3], st.l_cont_bp[:, own].float() * kb)
            del keep


def test_parameter_row_is_the_nuisance_proposals(scorers):
    """The row H1 writes is the one D1 writes for the nuisance test set:
    on the CPU both are ``params_vector``'s, bit for bit; on the card both
    kernels call params_row.cuh's ``write_params_row``, and neither keeps
    its own copy; a numpy transcription of that code agrees to an ulp."""
    scorer, state = scorers["dense"]
    par = scorers["params"]
    one = TState(*[x[None] for x in state])
    for idm, e in ((0, 0.3), (1, -0.7), (2, 1.1), (3, 0.2)):
        test, _, row_d1 = tm.nuisance_propose(torch.tensor(idm), torch.tensor(np.float32(e)), par,
                                              900.0, scorer.log_nfpb)
        _, row_h1 = scorer.vectors(one, test)
        assert row_h1.shape == (vc.N_ROW,) and torch.equal(row_h1, row_d1)
        np.testing.assert_allclose(params_row_transcribed(test, scorer.log_nfpb),
                                   row_h1.numpy(), rtol=4e-7)
    for name in ("step.cu", "vectors.cu"):
        src = (CSRC / name).read_text()
        assert '#include "params_row.cuh"' in src and "write_params_row(" in src, name
        assert "log_k3fact" not in src and "log_norm_circ" not in src, name


def test_scores_through_the_card_dispatch_match_pallas(scorers, monkeypatch):
    """B1's and B3's plain versions on the vectors of the card's dispatch
    (H1 transcribed) match the JAX package's Pallas scorers in the
    interpreter, and the scorer's own CPU path, bit for bit."""
    state, table, params, obs = scorers["jax_dense"]
    vs = variants(state)
    jbatch = JState(*[jnp.stack(xs) for xs in zip(*vs)])
    pallas = np.asarray(lp.make_pallas_scorer(table, obs, interpret=True)(jbatch, params))
    tp = convert.params_from_numpy(params._asdict())
    dense, _ = scorers["dense"]
    batch = stack_port(vs)
    want = dense(batch, tp)
    spy = route_to_card(monkeypatch, dense)
    got = dense(batch, tp)
    assert spy.calls == [(batch.pos.shape[0], True)]
    np.testing.assert_allclose(got.numpy(), pallas, rtol=SCORER_RTOL)
    assert torch.equal(got, want)
    # the nuisance call: a handed row, the genome an x[None] view
    row = lc.params_vector(tp, dense.log_nfpb)
    one = TState(*[x[0][None] for x in batch])
    assert torch.equal(dense(one, tp, pvec=row), want[:1]) and spy.calls[-1][1] is False

    rstate, rtable, rparams, robs = scorers["jax_repeat"]
    rv = repeat_variants(rstate)
    rbatch = JState(*[jnp.stack(xs) for xs in zip(*rv.values())])
    rpallas = np.asarray(lp.make_repeat_pallas_scorer(rtable, robs, interpret=True)(rbatch,
                                                                                   rparams))
    rscorer, _ = scorers["repeat"]
    rtp = scorers["params"]
    tb = TState(*[torch.stack(xs) for xs in zip(*[to_port(v) for v in rv.values()])])
    rwant = rscorer(tb, rtp)
    spy = route_to_card(monkeypatch, rscorer)
    rgot = rscorer(tb, rtp)
    assert spy.calls == [(tb.pos.shape[0], True)]
    np.testing.assert_allclose(rgot.numpy(), rpallas, rtol=REPEAT_RTOL, atol=REPEAT_ATOL)
    assert torch.equal(rgot, rwant)


def jax_closure(score):
    """The named inner functions of a JAX package scorer (``sub_vectors``,
    ``params_vector``, ``copy_vectors`` and the tables they close over)."""
    return dict(zip(score.__code__.co_freevars, (c.cell_contents for c in score.__closure__)))


def strided_batch(states: TState):
    """The batch with every field a (B, n) view at other strides: a column
    block of a wider matrix, so both strides differ from a copy's."""
    def view(x):
        wide = torch.zeros((x.shape[0], x.shape[1] + 5), dtype=x.dtype)
        wide[:, 2:2 + x.shape[1]] = x
        return wide[:, 2:2 + x.shape[1]]
    return TState(*[view(x) for x in states])


def plans(b, k):
    """The grids to hold the layout on: the wrapper's own plan, and every
    group size at 32 and 256 threads a block."""
    yield vc.plan(b, k)
    for threads in (32, 256):
        for group in vc.GROUPS:
            yield threads, group


@pytest.mark.parametrize("b,kind", [(1, "dense"), (65, "dense"), (130, "repeat"),
                                    (260, "dense")])
@pytest.mark.parametrize("layout", ("x[None]", "strided"))
def test_layout_matches_plain_and_jax(scorers, monkeypatch, b, kind, layout):
    """H1's (chunk, genome group) layout, transcribed block by block at the
    wrapper's plan and at every group size: each output written once, bit
    for bit the plain vectors (the ``a`` column on the repeat table) and
    the plain parameter row, at B = 1, 65, 130 and 260, on the nuisance
    call's ``x[None]`` view of one genome (broadcast to B at a genome
    stride of 0) or on a (B, n) view at other strides; and
    held to the JAX package's own ``sub_vectors`` / ``copy_vectors`` (every
    value equal, the JAX package dividing by 1,000 as torch on the CPU
    does) and ``params_vector`` (to an ulp: XLA's logs and powers are not
    torch's)."""
    scorer, state = scorers[kind]
    par = scorers["params"]
    batch = random_states(state, b, seed=b)
    # x[None]: the nuisance call's view of one genome (B = 1), broadcast to
    # B genomes at a genome stride of 0
    st = TState(*[x[0][None].expand(b, -1) for x in batch]) if layout == "x[None]" \
        else strided_batch(batch)
    assert layout != "strided" or st.start_bp.stride() == (state.n_frags + 5, 1)
    want = scorer.vectors_plain(st)
    want_row = lc.params_vector(par, scorer.log_nfpb)
    grids = set()
    for threads, group in plans(st.pos.shape[0], scorer.k):
        monkeypatch.setattr(vc, "plan", lambda b_, k_, t=threads, g=group: (t, g))
        a, keep, (vecs, row) = vc.vectors_args(st, scorer.sub_rows, par, scorer.log_nfpb)
        grids.add(h1_transcribed(a, reciprocal=False))
        _arr(a.row, np.float32, vc.N_ROW)[:] = row_of(a).numpy()
        for label, g, w in zip(scorer.VECTORS, vecs, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (label, threads, group)
        assert torch.equal(row, want_row)
        del keep
    assert len(grids) > 1
    # the JAX package's own functions, closed over by its Pallas scorers
    jstate, jtable, jparams, jobs = scorers[f"jax_{kind}"]
    if kind == "dense":
        inner = jax_closure(lp.make_pallas_scorer(jtable, jobs, interpret=True))
    else:
        inner = jax_closure(lp.make_repeat_pallas_scorer(jtable, jobs, interpret=True))
    jrow = np.asarray(inner["params_vector"](jparams))
    if kind == "repeat":
        # the repeat Pallas row ends in nfpb itself; the port's B3 reads it
        # from its scorer, and its row ends in log nfpb as B1's does
        jrow = np.append(jrow[:9], np.log(jrow[9]))
    np.testing.assert_allclose(want_row.numpy(), jrow, rtol=4e-7)
    for g in range(min(st.pos.shape[0], 3)):
        one = JState(*[jnp.asarray(x[g].numpy()) for x in st])
        if kind == "dense":
            j = [np.asarray(x)[:scorer.k] for x in inner["sub_vectors"](one)[:4]]
            for label, got, w in zip(scorer.VECTORS, vecs, j):
                np.testing.assert_array_equal(got[g].numpy(), w, err_msg=label)
        else:
            cv = [np.asarray(x) for x in inner["copy_vectors"](one)]   # (mc, S_pad) each
            slots, ok = scorer.slots.numpy(), scorer.slot_ok.numpy()
            s_idx, c_idx = np.nonzero(ok)
            pos = slots[s_idx, c_idx]
            for i, label in enumerate(("mid", "idc", "circ", "stot")):
                np.testing.assert_array_equal(vecs[i][g].numpy()[pos],
                                              cv[i][c_idx, s_idx], err_msg=label)
            np.testing.assert_array_equal(vecs[4][g].numpy()[pos],
                                          (cv[4] * cv[5])[c_idx, s_idx], err_msg="a")


def test_wrapper_counts_in_the_kernel_not_beside_it(scorers, monkeypatch):
    """The wrapper calls no ``LaunchCount.add``: the kernel adds one to the
    "vectors" counter itself (the stand-in library as block (0, 0)'s thread
    0), so ``n_launches`` equals the calls, with and without a row."""
    scorer, state = scorers["repeat"]
    spy = route_to_card(monkeypatch, scorer)
    batch = random_states(state, 9, seed=1)
    for k in range(5):
        scorer.vectors(batch if k % 2 else TState(*[x[:1] for x in batch]),
                       scorers["params"] if k < 3 else None)
    assert spy.calls == [(1, True), (9, True), (1, True), (9, False), (1, False)]
    assert spy.launches.by_key() == {"vectors": 5} and spy.n_launches == 5


def _bad(scorers, name):
    scorer, state = scorers["repeat"]
    st = TState(*[x[None] for x in state])
    sub = scorer.sub_rows
    par = scorers["params"]
    if name == "int64 field":
        return st._replace(ori=st.ori.long()), sub, None, None
    if name == "1-d fields":
        return state, sub, None, None
    if name == "field shape":
        return st._replace(circ=st.circ[:, :-1]), sub, None, None
    if name == "owner int64":
        return st, sub._replace(owner=sub.owner.long()), None, None
    if name == "prefix f64":
        return st, sub._replace(prefix=sub.prefix.double()), None, None
    if name == "accu length":
        return st, sub._replace(accu=sub.accu[:-1]), None, None
    if name == "strided len_half":
        return st, sub._replace(len_half=torch.stack([sub.len_half] * 2, 1)[:, 0]), None, None
    if name == "too many genomes":
        return TState(*[x.expand(vc.MAX_B + 1, -1) for x in st]), sub, None, None
    if name == "chain parameters":
        return st, sub, par._replace(fact=par.fact.expand(2)), scorer.log_nfpb
    if name == "f64 parameter":
        return st, sub, par._replace(d=par.d.double()), scorer.log_nfpb
    if name == "no log_nfpb":
        return st, sub, par, None
    raise KeyError(name)


BAD = ("int64 field", "1-d fields", "field shape", "owner int64", "prefix f64", "accu length",
       "strided len_half", "too many genomes", "chain parameters", "f64 parameter",
       "no log_nfpb")


@pytest.mark.parametrize("name", BAD)
def test_checks_refuse(scorers, name):
    with pytest.raises(ValueError):
        vc.check_vectors(*_bad(scorers, name))


def test_checks_accept_and_wrapper_refuses_cpu(scorers):
    scorer, state = scorers["repeat"]
    st = TState(*[x[None].expand(3, -1) for x in state])
    assert vc.check_vectors(st, scorer.sub_rows, scorers["params"], scorer.log_nfpb) == (
        3, state.n_frags, scorer.k)
    with pytest.raises(ValueError, match="on a card"):
        vc.VECTORS(st, scorer.sub_rows)
    assert vc.VECTORS.n_launches == 0


def test_ctypes_mirror_follows_the_source():
    """The argument block's fields, in order, as vectors.cu declares them."""
    src = (CSRC / "vectors.cu").read_text()
    body = re.search(r"struct VectorsArgs \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if decl.strip():
            head, *rest = decl.split(",")
            names.append(re.sub(r"\[.*?\]", "", head).replace("*", " ").split()[-1])
            names += [r.strip() for r in rest]
    assert names == [f for f, _ in vc.VectorsArgs._fields_]
    assert ctypes.sizeof(vc.VectorsArgs) == 336
    assert vc.READ == tuple(re.search(r"enum Field \{(.*?)\}", src).group(1).lower()
                            .replace(" = 0", "").replace(" ", "").split(",")[:-1])
