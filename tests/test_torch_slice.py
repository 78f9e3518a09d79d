"""The port's slice as a whole, against the JAX package, on the CPU.

- No file of graal_tpu_torch/ (its io/ and parallel/ packages included;
  nor chip_smoke.py or kernel_times.py) imports jax, graal_tpu or h5py,
  and matplotlib only inside a ``try`` that handles its absence (the
  optional figures of utils/plots.py and the snapshot's .png): the port
  must run where none of them is installed.
- ``graal_tpu_torch.entry.problem`` builds the same problem as
  ``__graft_entry__._problem`` (states, table, observed map, neighbour
  table bit for bit; params f32-equal).
- EM cycles driven through the dense scorer (its plain version on the
  CPU) commit the same mutations as the JAX cycle given the same draws;
  the carried likelihood agrees at rtol 1e-4, the scorer tolerance (the
  scorer's log-space math vs the JAX jnp pmf). The scorer never launches
  the CUDA kernel on the CPU.
- The entry points build on the card unless asked for the CPU: without a
  card, their default raises instead of falling back.
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from graal_tpu.core import likelihood as jl
from graal_tpu.core import mcmc as jm
from graal_tpu_torch import convert
from graal_tpu_torch import entry as tentry
from graal_tpu_torch.core import mcmc as tm
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from graal_tpu_torch.ops.likelihood_cuda import make_dense_scorer
from tests.test_torch_mcmc import jax_cycle_draws, port_draws
from tests.test_torch_state import assert_states_equal, to_port

ROOT = Path(__file__).resolve().parents[1]
SCORER_RTOL = 1e-4


def _imported_modules(path, unguarded=False):
    """The modules ``path`` imports; with ``unguarded``, only those not
    imported inside a ``try`` with an ImportError (or broader) handler."""
    tree = ast.parse(path.read_text(), filename=str(path))
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                h.type is None or (isinstance(h.type, ast.Name)
                                   and h.type.id in ("ImportError", "Exception"))
                for h in node.handlers):
            for stmt in node.body:
                guarded.update(id(n) for n in ast.walk(stmt))
    for node in ast.walk(tree):
        if unguarded and id(node) in guarded:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_graal_tpu():
    files = sorted((ROOT / "graal_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                ROOT / "kernel_times.py"]
    assert len(files) > 10
    assert {"pyramid.py", "native_io.py", "formats.py", "fasta.py"} <= \
        {p.name for p in files if p.parent.name == "io"}
    assert {"mtm.py", "model_hic.py", "tempering.py", "multilevel.py"} <= {p.name for p in files}
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "graal_tpu", "h5py"), \
                f"{path.relative_to(ROOT)} imports {mod}"
        for mod in _imported_modules(path, unguarded=True):
            assert mod.split(".")[0] != "matplotlib", \
                f"{path.relative_to(ROOT)} imports {mod} outside a guarded try"


def test_problem_matches_graft_entry():
    js, jt, jp, jobs, jnb = graft._problem(n_bins=30, n_contigs=4, seed=1)
    ts, tt, tp, tobs, tnb = tentry.problem(n_bins=30, n_contigs=4, seed=1, device="cpu")
    assert_states_equal(ts, js)
    for f in ("owner", "data_id", "len_kb", "accu", "prefix_kb", "suffix_kb"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)))
    assert tt.n_frags_per_bins == jt.n_frags_per_bins
    assert tp.astuple_np() == jp.astuple_np()
    np.testing.assert_array_equal(tobs, jobs)
    for f in ("xk", "pk", "dispatcher", "blacklist"):
        np.testing.assert_array_equal(getattr(tnb, f).numpy(), np.asarray(getattr(jnb, f)))


def test_em_cycles_through_dense_scorer_match_jax():
    js, jt, jp, obs, jnb = graft._problem(n_bins=32, n_contigs=4, seed=3)
    ts, tt, tp, _, tnb = tentry.problem(n_bins=32, n_contigs=4, seed=3, device="cpu")
    delta = tentry.DELTA
    n = js.n_frags
    scorer = make_dense_scorer(tt, obs, "cpu")
    cycle_t = tm.make_em_cycle(tt, obs, tnb, delta, sample_param=True, scorer=scorer)
    cycle_j = jm.make_em_cycle(jt, obs, jnb, delta, sample_param=True)
    cur_j = jm.explode_genome(js)
    cur_t = tm.explode_genome(ts)
    l_j = jl.log_likelihood(cur_j, jt, obs, jp)
    l_t = scorer(TState(*[x[None] for x in cur_t]), tp)[0]
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=SCORER_RTOL)
    par_j, par_t = jp, tp
    rng = np.random.default_rng(5)
    key = jax.random.key(13)
    for c in range(2):
        key, k_cycle = jax.random.split(key)
        order = rng.permutation(n).astype(np.int32)
        cur_j, par_j, l_j, m_j = cycle_j(cur_j, k_cycle, par_j, jnp.asarray(order),
                                         l_j, jnp.float32(1.0))
        draws = port_draws(jax_cycle_draws(k_cycle, n, jnb.pk.shape[1],
                                           tm.n_slots(tnb, delta)))
        cur_t, par_t, l_t, m_t = cycle_t(cur_t, draws, par_t,
                                         torch.as_tensor(order), l_t, 1.0)
        np.testing.assert_array_equal(m_t.op_sampled.numpy(), np.asarray(m_j.op_sampled))
        np.testing.assert_array_equal(m_t.id_f_sampled.numpy(),
                                      np.asarray(m_j.id_f_sampled))
        assert_states_equal(cur_t, cur_j, f"cycle {c}")
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=SCORER_RTOL)
        for f in jp._fields:
            np.testing.assert_allclose(float(getattr(par_t, f)),
                                       float(getattr(par_j, f)), rtol=SCORER_RTOL)
    check_invariants(cur_t)
    # the carried likelihood is the scorer's own value for the final state
    rescored = scorer(TState(*[x[None] for x in cur_t]), par_t)[0]
    assert rescored.item() == l_t.item()
    assert scorer.n_launches == 0


def test_entry_step_runs():
    step, args = tentry.entry("cpu", n_bins=24, n_contigs=3)
    state = args[0]
    new, (score, op, fb) = step(*args)
    check_invariants(new)
    assert torch.isfinite(score) and 0 <= int(op) < 13
    assert new.pos.shape == state.pos.shape
    assert convert.to_numpy(new)["pos"].dtype == np.int32


def test_synthetic_matches():
    """make_genome (random sub-fragment counts) and simulate_contacts on
    both branches: the numpy expectation, and the circular-contig branch
    through the port's expected_data_matrix (Poisson draws of f32-close
    expectations: equal counts)."""
    from graal_tpu.core import ops as jops
    from graal_tpu.utils import synthetic as jsyn
    from graal_tpu_torch.utils import synthetic as tsyn

    js, jt = jsyn.make_genome(20, 3, subs_per_bin=0, seed=6)
    ts, tt = tsyn.make_genome(20, 3, subs_per_bin=0, seed=6)
    assert_states_equal(ts, js)
    np.testing.assert_array_equal(tt.owner.numpy(), np.asarray(jt.owner))
    np.testing.assert_array_equal(tt.len_kb.numpy(), np.asarray(jt.len_kb))
    jp, tp = jsyn.default_params(fact=5000.0), tsyn.default_params(fact=5000.0)
    np.testing.assert_array_equal(tsyn.simulate_contacts(ts, tt, tp, seed=2),
                                  jsyn.simulate_contacts(js, jt, jp, seed=2))
    head = int(np.nonzero((np.asarray(js.id_c) == 1) & (np.asarray(js.pos) == 0))[0][0])
    tail = int(np.nonzero((np.asarray(js.id_c) == 1)
                          & (np.asarray(js.pos) == np.asarray(js.l_cont) - 1))[0][0])
    jcirc = jops.paste(js, head, tail, 5)
    assert int(np.asarray(jcirc.circ)[head]) == 1
    np.testing.assert_array_equal(
        tsyn.simulate_contacts(to_port(jcirc), tt, tp, seed=3),
        jsyn.simulate_contacts(jcirc, jt, jp, seed=3))


SMALL_ENTRY = {
    "problem": dict(n_bins=24, n_contigs=3),
    "entry": dict(n_bins=24, n_contigs=3),
    "repeat_problem": dict(n_bins=24, n_contigs=3, n_dups=2),
    "scale_problem": dict(n_bins=200, n_contigs=2, n_pieces=8),
    "scale_repeat_problem": dict(n_bins=400, n_dups=4),
}


@pytest.mark.parametrize("name", sorted(SMALL_ENTRY))
def test_entry_points_default_to_the_card(name):
    fn = getattr(tentry, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        out = fn(**SMALL_ENTRY[name])
        state = out[1][0] if name == "entry" else out[0]
        assert state.pos.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):   # no fallback to the CPU
            fn(**SMALL_ENTRY[name])
