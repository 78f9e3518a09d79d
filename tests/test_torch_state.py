"""Parity of graal_tpu_torch.core.state / core.subfrags / convert with the
JAX package: the same numpy inputs go through both, and every int32 field
must match bit for bit (f32 table fields too: both round the same f64
numpy values). Also holds the helpers the other test_torch_* files use."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import state as jstate_mod
from graal_tpu.core import subfrags as jsub
from graal_tpu.core.state import GenomeState as JState
from graal_tpu_torch import convert
from graal_tpu_torch.core import state as tstate_mod
from graal_tpu_torch.core import subfrags as tsub
from graal_tpu_torch.core.state import GenomeState as TState
from tests.conftest import make_random_state

# The port's test tensors are tiny: one intra-op thread per test worker
# keeps torch from oversubscribing the cores the JAX workers share. Every
# test_torch_* file imports this module.
torch.set_num_threads(1)


def to_port(jax_state) -> TState:
    return convert.state_from_numpy(jax_state._asdict())


def to_jax(port_state) -> JState:
    return JState(**{k: jnp.asarray(v) for k, v in convert.to_numpy(port_state).items()})


def assert_states_equal(port_state, jax_state, msg=""):
    """Bit-exact comparison of every field (any leading batch shape)."""
    got = convert.to_numpy(port_state)
    for f in JState._fields:
        want = np.asarray(getattr(jax_state, f))
        assert got[f].dtype == np.int32, f"{msg} {f} dtype {got[f].dtype}"
        np.testing.assert_array_equal(got[f], want, err_msg=f"{msg} field {f}")


def repeat_state(rng, n_frags=24, n_contigs=5):
    """A random state whose last 4 fragments are repeat copies (rep=1),
    one of them inactive."""
    s = make_random_state(rng, n_frags, n_contigs)._asdict()
    s = {k: np.asarray(v).copy() for k, v in s.items()}
    s["rep"][-4:] = 1
    s["activ"][-1] = 0
    return JState(**{k: jnp.asarray(v) for k, v in s.items()})


def one_frag_state():
    return JState.from_soa(dict(
        pos=[0], id_c=[0], start_bp=[0], len_bp=[5000], circ=[0], l_cont=[1],
        l_cont_bp=[5000]))


@pytest.mark.parametrize("with_circ", [False, True])
def test_from_soa_and_derived_fields(with_circ):
    rng = np.random.default_rng(3)
    js = make_random_state(rng, 30, 6, with_circ=with_circ)
    soa = {k: np.asarray(v) for k, v in js._asdict().items()}
    ts = TState.from_soa(soa)
    assert_states_equal(ts, js)
    assert ts.n_frags == js.n_frags
    assert int(ts.n_contigs()) == int(js.n_contigs())
    assert int(ts.max_id_contig()) == int(js.max_id_contig())
    # defaults of the optional fields
    minimal = {k: soa[k] for k in ("pos", "id_c", "start_bp", "len_bp", "circ",
                                   "l_cont", "l_cont_bp")}
    assert_states_equal(TState.from_soa(minimal), JState.from_soa(minimal))


@pytest.mark.parametrize("with_circ", [False, True])
def test_renormalize(with_circ):
    rng = np.random.default_rng(5)
    js = make_random_state(rng, 28, 5, with_circ=with_circ)
    # corrupt the derived fields; renormalize must rebuild them
    bad = js._replace(start_bp=js.start_bp * 0 + 7, l_cont=js.l_cont * 0,
                      l_cont_bp=js.l_cont_bp * 0 + 1)
    assert_states_equal(tstate_mod.renormalize(to_port(bad)),
                        jstate_mod.renormalize(bad))
    # batched form: each row renormalised independently
    batch = TState(*[torch.stack([a, b]) for a, b in
                     zip(to_port(bad), to_port(js))])
    out = tstate_mod.renormalize(batch)
    assert_states_equal(TState(*[x[1] for x in out]), js)


@pytest.mark.parametrize("with_circ", [False, True])
def test_derive_prev_next(with_circ):
    rng = np.random.default_rng(7)
    js = make_random_state(rng, 26, 4, with_circ=with_circ)
    tp, tn = tstate_mod.derive_prev_next(to_port(js))
    jp, jn = jstate_mod.derive_prev_next(js)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tn, jn)


def test_check_invariants_verdicts():
    rng = np.random.default_rng(9)
    js = make_random_state(rng, 20, 4, with_circ=True)
    assert tstate_mod.check_invariants(to_port(js)) == []
    corrupt = [
        js._replace(pos=js.pos.at[0].set(-1)),
        js._replace(start_bp=js.start_bp + 1),
        js._replace(l_cont=js.l_cont.at[3].add(1)),
        js._replace(ori=js.ori.at[2].set(0)),
        js._replace(circ=js.circ.at[5].set(1 - js.circ[5])),
    ]
    for bad in corrupt:
        want = jstate_mod.check_invariants(bad, raise_on_error=False)
        assert want
        assert tstate_mod.check_invariants(to_port(bad), raise_on_error=False) == want
        with pytest.raises(AssertionError):
            tstate_mod.check_invariants(to_port(bad))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dist_inter_genome(seed):
    rng = np.random.default_rng(seed)
    ref = make_random_state(rng, 24, 3)
    cur = make_random_state(rng, 24, 5, with_circ=True)
    init_prev, init_next = jstate_mod.derive_prev_next(ref)
    init_ori = np.asarray(ref.ori)
    orientable = rng.random(24) < 0.7
    skip = np.zeros(24, bool)
    skip[rng.integers(0, 24, 3)] = True
    for st in (ref, cur):
        want = jstate_mod.dist_inter_genome(st, init_prev, init_next, init_ori,
                                            orientable, skip)
        got = tstate_mod.dist_inter_genome(to_port(st), init_prev, init_next,
                                           init_ori, orientable, skip)
        assert got == want


def assert_tables_equal(tt, jt):
    for f in ("owner", "data_id", "len_kb", "accu", "prefix_kb", "suffix_kb"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert tt.n_data_sub == jt.n_data_sub
    assert tt.n_frags_per_bins == jt.n_frags_per_bins
    assert tt.has_repeats == jt.has_repeats


def test_sub_frag_tables():
    rng = np.random.default_rng(11)
    n_bins = 20
    w = rng.integers(1, 4, n_bins)
    sub_ids = np.zeros((n_bins, 4), np.int64)
    sub_len = np.zeros((n_bins, 3))
    sub_acc = np.zeros((n_bins, 3))
    k = 0
    for b in range(n_bins):
        sub_ids[b, 3] = w[b]
        for s in range(w[b]):
            sub_ids[b, s] = k
            sub_len[b, s] = rng.uniform(0.5, 4.0)
            sub_acc[b, s] = rng.integers(1, 4)
            k += 1
    id_d = np.arange(n_bins)
    assert_tables_equal(tsub.build_sub_frag_table(sub_ids, sub_len, sub_acc, id_d),
                        jsub.build_sub_frag_table(sub_ids, sub_len, sub_acc, id_d))
    # copy-expanded (repeat) ids
    id_rep = np.concatenate([id_d, [3, 3, 11]])
    assert_tables_equal(tsub.build_sub_frag_table(sub_ids, sub_len, sub_acc, id_rep),
                        jsub.build_sub_frag_table(sub_ids, sub_len, sub_acc, id_rep))
    lens = rng.integers(1000, 9000, 12)
    assert_tables_equal(tsub.trivial_table(lens), jsub.trivial_table(lens))
    # table_from_level
    bts = np.stack([np.cumsum(w) - w, np.cumsum(w) - 1], axis=1)
    subs = {"len_bp": rng.integers(500, 4000, int(w.sum())),
            "n_accu": rng.integers(1, 3, int(w.sum()))}
    assert_tables_equal(tsub.table_from_level({}, subs, bts),
                        jsub.table_from_level({}, subs, bts))
    with pytest.raises(ValueError):
        tsub.table_from_level({}, subs, np.array([[0, 3]]))


def test_convert_round_trip():
    rng = np.random.default_rng(13)
    js = make_random_state(rng, 16, 3)
    ts = to_port(js)
    assert all(x.dtype == torch.int32 for x in ts)
    assert_states_equal(to_port(to_jax(ts)), js)
    jt = jsub.trivial_table(np.asarray(js.len_bp))
    assert_tables_equal(convert.table_from_numpy(jt._asdict()), jt)
