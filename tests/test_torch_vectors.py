"""The dense scorers' sub-fragment vectors and parameter row (kernel H1,
graal_tpu_torch/csrc/vectors.cu, wrapper ops/vectors_cuda.py) on the CPU.

A CUDA kernel cannot run here, so H1's function is held through a numpy
transcription that reads the wrapper's own argument block (pointers and
strides, as the kernel does) and rounds in the kernel's order:

- bit for bit against the plain vectors (``CopyRowScorer.geometry``,
  ``RepeatScorer.vectors_plain``) on random genomes with circular contigs,
  deactivated copies and both orientations, at B = 1 as the nuisance
  call's ``x[None]`` view and with fields at other strides, dividing by
  1,000 as torch does on the CPU; and, multiplying by the f32 reciprocal
  as the kernel and torch on the card do, against the plain version's
  operations in that form;
- the parameter row equal to the nuisance proposal's (kernel D1's), whose
  code H1 shares (``csrc/params_row.cuh``);
- the plain scorers fed through the card's dispatch (a stand-in wrapper
  that runs the transcription) against the JAX package's
  ``make_pallas_scorer`` / ``make_repeat_pallas_scorer`` in the Pallas
  interpreter at the existing tolerances;
- the wrapper's checks, its refusal of CPU tensors, and the ctypes mirror
  of the argument block parsed from the .cu.
"""

import ctypes
import re
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
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import likelihood_cuda as lc
from graal_tpu_torch.ops import vectors_cuda as vc
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
    """H1 in numpy from its argument block: each output (b, k) from the
    fields at owner[k] read at their strides, in the kernel's operation
    order (int32 -> f32 rounding to nearest, then the scale by 1 / 1000,
    then (start_kb + w) + len_half). ``reciprocal``: scale by the block's
    f32 reciprocal (the kernel, torch on the card) instead of dividing by
    1,000 (torch on the CPU). Writes the block's outputs."""
    b_n, k_n = a.B, a.K
    owner = _arr(a.owner, np.int32, k_n).astype(np.int64)
    b = np.arange(b_n)[:, None]

    def field(i):
        idx = a.st_bs[i] * b + a.st_is[i] * owner[None, :]
        return _arr(a.st[i], np.int32, int(idx.max()) + 1)[idx]

    def kb(x):
        x = x.astype(np.float32)
        return x * np.float32(a.inv_kb) if reciprocal else x / np.float32(1000.0)

    prefix, suffix, len_half = (_arr(p, np.float32, k_n) for p in (a.prefix, a.suffix,
                                                                    a.len_half))
    w = np.where(field(1) == 1, prefix[None, :], suffix[None, :])
    mid = (kb(field(0)) + w) + len_half[None, :]
    outs = [(a.mid, mid), (a.idc, field(2)), (a.circ, field(3).astype(np.float32)),
            (a.stot, kb(field(4)))]
    if a.a:
        accu = _arr(a.accu, np.float32, k_n)
        outs.append((a.a, np.where(field(5) == 1, accu[None, :], np.float32(0.0))))
    for ptr, x in outs:
        _arr(ptr, x.dtype, b_n * k_n)[:] = x.reshape(-1)


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


class StandIn(vc.VectorKernels):
    """The wrapper with its launch replaced by the transcription: the
    checks and the argument block are the wrapper's own, on CPU tensors;
    the row is the plain version's."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __call__(self, states, sub, params=None, log_nfpb=None):
        a, keep, (vecs, row) = vc.vectors_args(states, sub, params, log_nfpb)
        h1_transcribed(a, reciprocal=False)
        if row is not None:
            row.copy_(lc.params_vector(params, log_nfpb))
        self.calls.append((tuple(states.pos.shape), params is not None))
        del keep
        return vecs, row


def route_to_card(monkeypatch, scorer):
    """Send ``scorer``'s vectors through its card branch and a stand-in."""
    spy = StandIn()
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
    assert spy.calls == [(batch.pos.shape, True)]
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
    assert spy.calls == [(tb.pos.shape, True)]
    np.testing.assert_allclose(rgot.numpy(), rpallas, rtol=REPEAT_RTOL, atol=REPEAT_ATOL)
    assert torch.equal(rgot, rwant)


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
    assert ctypes.sizeof(vc.VectorsArgs) == 320
    assert vc.READ == tuple(re.search(r"enum Field \{(.*?)\}", src).group(1).lower()
                            .replace(" = 0", "").replace(" ", "").split(",")[:-1])
