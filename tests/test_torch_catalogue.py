"""The 13-candidate catalogues' public entry points against the JAX package.

``graal_tpu_torch.core.candidates.build_candidates`` / ``mh_candidates``
send a state on a card to the catalogue kernels (C1, C2:
``ops.candidates_cuda``) and any other state to the plain versions. Here,
on the CPU, the public functions take the plain versions through that
dispatch, and every field must equal ``graal_tpu.core.candidates`` (under
``jax.vmap``, one genome a row) bit for bit: integer state algebra. The
inputs, made from numpy seeds, cover linear and circular contigs,
singletons, f_a == f_b, repeat copies active and inactive (swap activity,
mode 8), 1-fragment genomes, one genome broadcast and one genome a row;
f_a given as an int, a 0-d tensor or one a genome, and max_id as None, an
int, a 0-d tensor or one a genome; the delta engine's mini-states on a
chains axis with each chain's maximum, and ROADMAP section C's
id-collision input. The wrapper's argument checks run as a pure function
on CPU tensors; the kernels themselves run only on a card
(``chip_smoke.py`` phase 3c holds them to the plain versions there).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import candidates as jc
from graal_tpu.core import delta as jd
from graal_tpu.core.state import GenomeState as JState
from graal_tpu_torch.core import candidates as tc
from graal_tpu_torch.core import delta as td
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.ops import candidates_cuda as cc
from tests.test_torch_state import assert_states_equal

B = 8
N = 24
_JAX = {kind: jax.jit(jax.vmap(fn)) for kind, fn in
        (("em", jc.build_candidates), ("mh", jc.mh_candidates))}
_PORT = {"em": tc.build_candidates, "mh": tc.mh_candidates}
_PLAIN = {"em": tc.build_candidates_plain, "mh": tc.mh_candidates_plain}


def random_soa(rng, n=N, n_contigs=5, circ=False, repeats=False):
    """A valid random genome: contigs of random sizes with random ids (a
    circular one now and then when ``circ``); with ``repeats`` about a third
    of the fragments are repeat copies, half of those inactive."""
    n_contigs = min(n_contigs, n)
    cuts = np.sort(rng.choice(np.arange(1, n), n_contigs - 1, replace=False)) \
        if n_contigs > 1 else np.array([], np.int64)
    sizes = np.diff(np.concatenate([[0], cuts, [n]]))
    perm = rng.permutation(n)
    ids = rng.permutation(np.arange(1, 3 * n_contigs + 1))[:n_contigs]
    soa = {k: np.zeros(n, np.int32) for k in ("pos", "id_c", "start_bp", "circ", "l_cont",
                                              "l_cont_bp")}
    soa["len_bp"] = rng.integers(1000, 20000, n).astype(np.int32)
    k = 0
    for c, size in enumerate(sizes):
        members = perm[k:k + size]
        k += size
        is_circ = int(circ and size > 2 and rng.random() < 0.5)
        off = np.cumsum(soa["len_bp"][members]) - soa["len_bp"][members]
        soa["pos"][members] = np.arange(size)
        soa["id_c"][members] = ids[c]
        soa["start_bp"][members] = off
        soa["circ"][members] = is_circ
        soa["l_cont"][members] = size
        soa["l_cont_bp"][members] = soa["len_bp"][members].sum()
    soa["ori"] = rng.choice([-1, 1], n).astype(np.int32)
    soa["rep"] = (rng.random(n) < 0.35).astype(np.int32) if repeats else np.zeros(n, np.int32)
    soa["activ"] = np.where((soa["rep"] == 1) & (rng.random(n) < 0.5), 0, 1).astype(np.int32)
    soa["id_d"] = rng.permutation(n).astype(np.int32)
    return soa


STATES = {   # name -> (soa maker, one genome a row)
    "linear": (lambda rng: random_soa(rng), False),
    "circular": (lambda rng: random_soa(rng, n_contigs=4, circ=True), False),
    "repeats": (lambda rng: random_soa(rng, circ=True, repeats=True), False),
    "singletons": (lambda rng: random_soa(rng, n_contigs=N - 3, repeats=True), False),
    "one_fragment": (lambda rng: random_soa(rng, n=1, n_contigs=1), False),
    "per_genome": (lambda rng: random_soa(rng, circ=True, repeats=True), True),
}


def make_state(name, rng):
    """(port state: fields (n,) or (B, n); the same as (B, n) numpy rows)."""
    make, per_genome = STATES[name]
    soas = [make(rng) for _ in range(B if per_genome else 1)]
    rows = {k: np.stack([s[k] for s in soas]) for k in TState._fields}
    if not per_genome:
        rows = {k: np.repeat(v, B, 0) for k, v in rows.items()}
        return TState(*[torch.as_tensor(soas[0][k]) for k in TState._fields]), rows
    return TState(*[torch.as_tensor(rows[k]) for k in TState._fields]), rows


def pairs(rng, rows):
    """(f_a (B,), f_b (B,)): f_a on a repeat copy where there is one, one
    row with f_b == f_a."""
    n = rows["pos"].shape[1]
    fa = rng.integers(0, n, B)
    copies = np.flatnonzero(rows["rep"][0])
    if copies.size:
        fa[::2] = rng.choice(copies, fa[::2].size)
    fb = rng.integers(0, n, B)
    fb[0] = fa[0]
    return fa.astype(np.int32), fb.astype(np.int32)


def fa_arg(form, fa):
    """f_a as the port takes it, and the (B,) values it stands for."""
    if form == "int":
        return int(fa[0]), np.full(B, fa[0], np.int32)
    if form == "0d":
        return torch.tensor(int(fa[0])), np.full(B, fa[0], np.int32)
    return torch.as_tensor(fa), fa


def max_arg(form, rng, rows):
    """max_id as the port takes it, and the (B,) values it stands for: the
    state's own maximum (over every row), a larger int, a 0-d tensor, one
    per genome (some below the state's maximum)."""
    top = int(rows["id_c"].max())
    if form == "none":
        return None, np.full(B, top, np.int32)
    if form == "int":
        return top + 7, np.full(B, top + 7, np.int32)
    if form == "0d":
        return torch.tensor(top + 2, dtype=torch.int64), np.full(B, top + 2, np.int32)
    per = (top - 3 + rng.integers(0, 9, B)).astype(np.int32)
    return torch.as_tensor(per), per


def jax_catalogue(kind, rows, fa, fb, mx):
    state = JState(**{k: jnp.asarray(v) for k, v in rows.items()})
    return _JAX[kind](state, jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(mx))


@pytest.mark.parametrize("fa_form", ["int", "0d", "vec"])
@pytest.mark.parametrize("state_name", list(STATES))
@pytest.mark.parametrize("kind", ["em", "mh"])
def test_catalogue_matches_reference(kind, state_name, fa_form):
    """The public catalogue on the CPU equals the JAX package's, every
    field, for each form of max_id, on two seeds."""
    for seed in range(2):
        rng = np.random.default_rng(1000 * seed + 17)
        state, rows = make_state(state_name, rng)
        fa, fb = pairs(rng, rows)
        fa_port, fa_vals = fa_arg(fa_form, fa)
        for max_form in ("none", "int", "0d", "vec"):
            mx_port, mx_vals = max_arg(max_form, rng, rows)
            got = _PORT[kind](state, fa_port, torch.as_tensor(fb), max_id=mx_port)
            assert got.pos.shape == (B, 13, rows["pos"].shape[1])
            assert_states_equal(got, jax_catalogue(kind, rows, fa_vals, fb, mx_vals),
                                f"{kind} {state_name} f_a {fa_form} max_id {max_form} seed {seed}")


@pytest.mark.parametrize("state_name", ["repeats", "per_genome"])
@pytest.mark.parametrize("kind", ["em", "mh"])
def test_catalogue_with_base(kind, state_name):
    """``with_base``: the base genome in slot 0, the catalogue in 1-13, each
    field (B, 14, n) as the delta engine reads it."""
    rng = np.random.default_rng(5)
    state, rows = make_state(state_name, rng)
    fa, fb = pairs(rng, rows)
    fa, fb = torch.as_tensor(fa), torch.as_tensor(fb)
    full = _PORT[kind](state, fa, fb, with_base=True)
    cands = _PORT[kind](state, fa, fb)
    for k, name in enumerate(TState._fields):
        assert full[k].shape == (B, 14, N)
        np.testing.assert_array_equal(full[k][:, 0].numpy(), rows[name], err_msg=name)
        assert torch.equal(full[k][:, 1:], cands[k]), name


def chain_minis(rng, n_chains=2, m=4, f_max=16):
    """The delta engine's mini-states of ``n_chains`` chains on a chains
    axis (extract_rows_each, gather_mini) with each chain's maximum, and
    the JAX package's per (chain, neighbour) mini-states."""
    soas = [random_soa(rng, n=40, n_contigs=6, circ=True, repeats=True) for _ in range(n_chains)]
    state = TState(*[torch.as_tensor(np.stack([s[k] for s in soas])) for k in TState._fields])
    f_as = torch.as_tensor(rng.integers(0, 40, n_chains))
    ids = torch.as_tensor(rng.integers(0, 40, (n_chains, m)))
    ids[0, 0] = f_as[0]
    rows, valid, _ = td.extract_rows_each(state, f_as, ids, f_max)
    minis = TState(*[x.reshape(n_chains * m, f_max) for x in td.gather_mini(state, rows, valid)])
    lf_a = (rows == f_as[:, None, None]).int().argmax(-1).reshape(-1)
    lf_b = (rows == ids[..., None]).int().argmax(-1).reshape(-1)
    max_id = state.id_c.amax(-1).repeat_interleave(m)
    want_minis = []
    for c in range(n_chains):
        js = JState(**{k: jnp.asarray(v) for k, v in soas[c].items()})
        for k in range(m):
            r, v, _ = jd.extract_rows(js, jnp.int32(int(f_as[c])), jnp.int32(int(ids[c, k])),
                                      f_max)
            np.testing.assert_array_equal(rows[c, k].numpy(), np.asarray(r))
            want_minis.append(jd.gather_mini(js, r, v))
    want = {k: np.stack([np.asarray(getattr(s, k)) for s in want_minis])
            for k in TState._fields}
    return minis, lf_a, lf_b, max_id, want


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("kind", ["em", "mh"])
def test_catalogue_on_chain_minis(kind, with_base):
    """Mini-states of two chains' neighbours, each row with its chain's
    whole-genome maximum (the chains path of the delta engine): equal to
    the JAX package's catalogue of each JAX mini-state."""
    rng = np.random.default_rng(11)
    for _ in range(3):
        minis, lf_a, lf_b, max_id, rows = chain_minis(rng)
        for k in TState._fields:
            np.testing.assert_array_equal(getattr(minis, k).numpy(), rows[k], err_msg=k)
        got = _PORT[kind](minis, lf_a, lf_b, max_id=max_id, with_base=with_base)
        if with_base:
            got = TState(*[x[:, 1:] for x in got])
        assert_states_equal(got, jax_catalogue(kind, rows, lf_a.numpy().astype(np.int32),
                                               lf_b.numpy().astype(np.int32),
                                               max_id.numpy()), f"{kind} base {with_base}")


@pytest.mark.parametrize("max_form", ["0d", "vec"])
def test_mh_catalogue_collision_input(max_form):
    """ROADMAP section C's input through the public MH catalogue, as the
    delta engine calls it (the base slot, max_id a tensor): candidate 10
    takes the mini's own maximum 4 as its fresh id and circularises, as the
    JAX package does."""
    soa = dict(pos=[0, 1, 0, 1], id_c=[3, 3, 4, 4], start_bp=[0, 1000, 0, 1000],
               len_bp=[1000] * 4, circ=[0] * 4, l_cont=[2] * 4, l_cont_bp=[2000] * 4)
    ts = TState.from_soa(soa)
    js = JState.from_soa(soa)
    rows, valid, _ = td.extract_rows_each(ts, torch.tensor(1), torch.tensor([0]), 2)
    mini, = td.drop_chain(td.gather_mini(*td.lift_chain(ts, rows, valid)))
    mx = ts.id_c.amax() if max_form == "0d" else ts.id_c.amax().reshape(1)
    got = tc.mh_candidates(mini, torch.tensor([1]), torch.tensor([0]), max_id=mx,
                           with_base=True)
    r, v, _ = jd.extract_rows(js, jnp.int32(1), jnp.int32(0), 2)
    want = jc.mh_candidates(jd.gather_mini(js, r, v), jnp.int32(1), jnp.int32(0),
                            jnp.max(js.id_c))
    assert_states_equal(TState(*[x[0, 1:] for x in got]), want)
    assert got.id_c[0, 11].tolist() == [4, 4] and got.circ[0, 11].tolist() == [1, 1]


# ---- the wrapper's argument checks and the dispatch -----------------------

def _state(n=6, rows=None, dtype=torch.int32):
    shape = (n,) if rows is None else (rows, n)
    return TState(*[torch.zeros(shape, dtype=dtype) for _ in TState._fields])


def test_check_args_accepts_what_the_kernel_takes():
    fb = torch.tensor([1, 2, 3], dtype=torch.int64)
    n, m, rows, strides, fa, mx = cc.check_args("em", _state(), 2, fb, None)
    assert (n, m, rows, strides) == (6, 3, 1, ([0] * 11, [1] * 11))
    assert fa == (None, 2, 0, 0) and mx == (None, 0, 0, 0)
    per = _state(rows=3)
    top = torch.tensor(9, dtype=torch.int32)
    n, m, rows, strides, fa, mx = cc.check_args("mh", per, torch.tensor([0, 1, 2]), fb,
                                                top.expand(3))
    assert (rows, strides) == (3, ([6] * 11, [1] * 11))
    assert fa[2:] == (1, 1) and mx[2:] == (0, 0)      # int64 / stride 1; int32 / stride 0
    expanded = TState(*[x.expand(3, -1) for x in _state()])
    assert cc.check_args("em", expanded, 0, fb, 4)[2:4] == (1, ([0] * 11, [1] * 11))
    # the delta engine's mini-states: views of one (M, n, 11) gather
    packed = TState(*torch.zeros((3, 6, 11), dtype=torch.int32).unbind(-1))
    assert cc.check_args("em", packed, 0, fb, 4)[2:4] == (3, ([66] * 11, [11] * 11))


def _bad(name):
    """(kind, state, f_a, f_b, max_id) with one thing wrong."""
    fb = torch.tensor([1, 2, 3])
    s = _state()
    meta = torch.empty(3, dtype=torch.int64, device="meta")
    return {
        "kind": ("xx", s, 0, fb, None),
        "field_dtype": ("em", _state(dtype=torch.int64), 0, fb, None),
        "field_count": ("em", tuple(s) + (s.pos,), 0, fb, None),
        "field_rows": ("em", _state(rows=2), 0, fb, None),
        "field_width": ("em", s._replace(ori=torch.zeros(5, dtype=torch.int32)), 0, fb, None),
        "field_dims": ("em", s._replace(ori=torch.zeros((1, 1, 6), dtype=torch.int32)), 0, fb,
                       None),
        "field_device": ("em", s._replace(rep=torch.empty(6, dtype=torch.int32, device="meta")),
                         0, fb, None),
        "no_fragment": ("em", _state(n=0), 0, fb, None),
        "fb_2d": ("em", s, 0, fb[None], None),
        "fb_dtype": ("em", s, 0, fb.float(), None),
        "fb_stride": ("em", s, 0, torch.arange(6)[::2], None),
        "fb_device": ("em", s, 0, meta, None),
        "fa_range": ("em", s, 6, fb, None),
        "fa_count": ("em", s, torch.tensor([0, 1]), fb, None),
        "fa_dtype": ("em", s, torch.tensor(0.0), fb, None),
        "fa_type": ("em", s, 0.5, fb, None),
        "max_dtype": ("em", s, 0, fb, torch.tensor(3.0)),
        "max_device": ("mh", s, 0, fb, meta),
        "max_bool": ("mh", s, 0, fb, True),
    }[name]


@pytest.mark.parametrize("name", ["kind", "field_dtype", "field_count", "field_rows",
                                  "field_width", "field_dims", "field_device", "no_fragment",
                                  "fb_2d", "fb_dtype", "fb_stride", "fb_device", "fa_range",
                                  "fa_count", "fa_dtype", "fa_type", "max_dtype", "max_device",
                                  "max_bool"])
def test_check_args_refuses(name):
    with pytest.raises(ValueError):
        cc.check_args(*_bad(name))


def test_wrapper_refuses_a_cpu_state():
    with pytest.raises(ValueError, match="card"):
        cc.CATALOGUE("em", _state(), 0, torch.tensor([1]))
    assert cc.CATALOGUE.launches.by_key() == {}


class _Spy:
    def __init__(self):
        self.calls = []

    def __call__(self, kind, state, f_a, f_b, max_id, with_base):
        self.calls.append((kind, state, f_a, f_b, max_id, with_base))
        return _PLAIN[kind](state, f_a, f_b, max_id, with_base)


@pytest.mark.parametrize("kind", ["em", "mh"])
def test_dispatch(kind, monkeypatch):
    """A CPU state never reaches the wrapper; a card state goes to it (here
    ``_on_card`` called directly) with f_b made int64 and contiguous, f_a
    and max_id moved to the state's device, the state's fields as given
    (the kernel reads them at their strides)."""
    spy = _Spy()
    monkeypatch.setattr(tc, "CATALOGUE", spy)
    rng = np.random.default_rng(3)
    state, rows = make_state("repeats", rng)
    fa, fb = pairs(rng, rows)
    got = _PORT[kind](state, int(fa[0]), torch.as_tensor(fb))
    assert spy.calls == []
    want = _PLAIN[kind](state, int(fa[0]), torch.as_tensor(fb))
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    strided = TState(*[torch.stack([x, x], -1)[..., 0] for x in state])
    out = tc._on_card(kind, strided, np.int64(fa[0]), torch.as_tensor(fb.astype(np.int16)),
                      np.int32(7), True)
    (k, st, f_a, f_b, mx, wb), = spy.calls
    assert (k, wb) == (kind, True)
    assert all(a is b for a, b in zip(st, strided))
    assert f_b.dtype == torch.int64 and f_b.is_contiguous()
    assert isinstance(f_a, int | np.integer) and isinstance(mx, int | np.integer)
    want = _PLAIN[kind](state, int(fa[0]), torch.as_tensor(fb), 7, True)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
