"""Parity of graal_tpu_torch.core.ops / core.candidates with the JAX
package: integer state arithmetic, so every field must match bit for bit.

Each port op runs once on a batch of (state, fragment arguments) rows;
the JAX op runs per row under vmap. Inputs: conftest.make_random_state
with and without circular contigs, a repeat state (swap_activity), rows
with fA == fB, and a 1-fragment genome.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graal_tpu.core import candidates as jcand
from graal_tpu.core import ops as jops
from graal_tpu_torch.core import candidates as tcand
from graal_tpu_torch.core import ops as tops
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from tests.conftest import make_random_state
from tests.test_torch_state import (assert_states_equal, one_frag_state,
                                    repeat_state, to_port)

N_ROWS = 24


def batch_port(js, n):
    return TState(*[x.expand(n, -1) for x in to_port(js)])


def i32(x):
    return torch.as_tensor(np.asarray(x, np.int32))


def rows(rng, n, n_rows=N_ROWS):
    """(f_a, f_b) rows: random pairs plus fA == fB rows."""
    fa = rng.integers(0, n, n_rows)
    fb = rng.integers(0, n, n_rows)
    fb[: n_rows // 4] = fa[: n_rows // 4]
    return fa.astype(np.int32), fb.astype(np.int32)


def states(seed):
    rng = np.random.default_rng(seed)
    return {
        "linear": make_random_state(rng, 24, 5),
        "circular": make_random_state(rng, 24, 4, with_circ=True),
        "repeats": repeat_state(rng),
    }


KINDS = ("linear", "circular", "repeats")
FOUR_ARG = ("pop_in_1", "pop_in_2", "pop_in_3", "pop_in_4")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["flip", "swap_activity", "pop_out", "split",
                                  "paste", *FOUR_ARG])
def test_op_bit_exact(name, kind):
    rng = np.random.default_rng(hash((name, kind)) % 2 ** 32)
    js = states(17)[kind]
    n = js.n_frags
    fa, fb = rows(rng, n)
    mx = np.full(N_ROWS, int(np.max(np.asarray(js.id_c))) + rng.integers(0, 3),
                 np.int32)
    sign = rng.choice([-1, 1], N_ROWS).astype(np.int32)
    up = rng.integers(0, 2, N_ROWS).astype(np.int32)
    jop, top = getattr(jops, name), getattr(tops, name)
    tb = batch_port(js, N_ROWS)
    if name == "flip":
        want = jax.vmap(lambda a: jop(js, a))(fa)
        got = top(tb, i32(fa))
    elif name in ("swap_activity", "pop_out"):
        want = jax.vmap(lambda a, m: jop(js, a, m))(fa, mx)
        got = top(tb, i32(fa), i32(mx))
    elif name == "split":
        want = jax.vmap(lambda a, u, m: jop(js, a, u, m))(fa, up, mx)
        got = top(tb, i32(fa), i32(up), i32(mx))
        # Python-int upstream (as build_candidates passes it)
        for u in (0, 1):
            want_u = jax.vmap(lambda a, m: jop(js, a, u, m))(fa, mx)
            assert_states_equal(top(tb, i32(fa), u, i32(mx)), want_u, f"up={u}")
    elif name == "paste":
        want = jax.vmap(lambda a, b, m: jop(js, a, b, m))(fa, fb, mx)
        got = top(tb, i32(fa), i32(fb), i32(mx))
    else:
        # insertion ops take a state where f_pop is a singleton
        popped = jax.vmap(lambda a, m: jops.pop_out(js, a, m))(fa, mx)
        want = jax.vmap(lambda s, a, b, o, m: jop(s, a, b, o, m))(
            popped, fa, fb, sign, mx + 1)
        got = top(to_port(popped), i32(fa), i32(fb), i32(sign), i32(mx + 1))
    assert_states_equal(got, want, f"{name}/{kind}")


def test_swap_activity_toggles_repeats():
    js = states(3)["repeats"]
    n = js.n_frags
    fa = np.arange(n, dtype=np.int32)
    mx = np.full(n, 40, np.int32)
    got = tops.swap_activity(batch_port(js, n), i32(fa), i32(mx))
    want = jax.vmap(lambda a, m: jops.swap_activity(js, a, m))(fa, mx)
    assert_states_equal(got, want)
    toggled = got.activ.numpy()[np.arange(n), fa] != np.asarray(js.activ)
    np.testing.assert_array_equal(toggled, np.asarray(js.rep) == 1)


_jax_cands = jax.jit(jax.vmap(jcand.build_candidates, in_axes=(None, None, 0)))


def _jax_candidates(js, fa, ids):
    return _jax_cands(js, jnp.int32(fa), jnp.asarray(ids))


@pytest.mark.parametrize("kind", KINDS)
def test_build_candidates_bit_exact(kind):
    rng = np.random.default_rng(23)
    js = states(29)[kind]
    ts = to_port(js)
    n = js.n_frags
    for _ in range(4):
        fa = int(rng.integers(0, n))
        ids = rng.integers(0, n, 5).astype(np.int32)
        ids[0] = fa                              # an fA == fB proposal
        got = tcand.build_candidates(ts, torch.tensor(fa), i32(ids))
        assert got.pos.shape == (5, tcand.N_CANDIDATES, n)
        want = _jax_candidates(js, fa, ids)
        assert_states_equal(got, want, f"fa={fa}")
        # a Python-int fA builds the same catalogue
        assert_states_equal(tcand.build_candidates(ts, fa, i32(ids)), want)
        for b in range(5):
            for op in range(tcand.N_CANDIDATES):
                check_invariants(TState(*[x[b, op] for x in got]))


def test_build_candidates_one_fragment_genome():
    js = one_frag_state()
    got = tcand.build_candidates(to_port(js), 0, i32([0]))
    assert_states_equal(got, _jax_candidates(js, 0, np.array([0], np.int32)))
    for op in range(tcand.N_CANDIDATES):
        check_invariants(TState(*[x[0, op] for x in got]))
