"""Parity of graal_tpu_torch.multilevel with the JAX package, and the
coarse-to-fine runs of the port on the CPU.

- ``project_state_to_sub`` gives the JAX projection exactly: identity
  order, a reversed bin, reordered contigs (tests/test_multilevel.py's
  cases), random states with circular contigs, and a coarse genome the JAX
  package assembled.
- ``run_multilevel`` (dense) and ``scale.run_multilevel`` (sparse) run on
  the CPU from level 2 down to level 1 as tests/test_multilevel.py's
  ``test_run_multilevel`` asserts: the final genome lives at level 1, the
  invariants hold, the refinement does not lose likelihood.
"""

import numpy as np
import jax
import pytest

from graal_tpu import multilevel as jml
from graal_tpu.core import ops
from graal_tpu.core.state import GenomeState as JState
from graal_tpu_torch import multilevel as tml
from graal_tpu_torch.core.state import GenomeState as TState
from graal_tpu_torch.core.state import check_invariants
from tests.conftest import make_random_state
from tests.test_ops import linear_state
from tests.test_torch_state import to_port


def assert_projection_equal(state, bin_to_subs, sub_len):
    want = jml.project_state_to_sub(state, bin_to_subs, sub_len)
    got = tml.project_state_to_sub(to_port(state), bin_to_subs, sub_len)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    check_invariants(TState.from_soa(got))
    return got


def test_projection_cases_match():
    ident = linear_state([2], len_bp=[600, 900])
    two = (np.array([[0, 1], [2, 3]]), np.array([300, 300, 400, 500]))
    assert_projection_equal(ident, *two)
    assert_projection_equal(ops.flip(ident, 1), *two)
    s2 = ops.pop_in_3(linear_state([2, 1], len_bp=[500, 500, 700]), 2, 0, 1, 1)
    got = assert_projection_equal(s2, np.array([[0, 0], [1, 2], [3, 4]]),
                                  np.array([500, 250, 250, 350, 350]))
    order = np.argsort(np.where(got["id_c"] == 0, got["pos"], 99))[:5]
    assert order.tolist() == [0, 3, 4, 1, 2]


@pytest.mark.parametrize("with_circ", [False, True])
def test_projection_random_states_match(with_circ):
    rng = np.random.default_rng(5 + with_circ)
    for _ in range(5):
        state = make_random_state(rng, 15, 4, with_circ=with_circ)
        widths = rng.integers(1, 4, 15)
        hi = np.cumsum(widths) - 1
        bin_to_subs = np.stack([hi - widths + 1, hi], axis=1)
        sub_len = rng.integers(200, 900, int(widths.sum()))
        state = state._replace(ori=jax.numpy.asarray(rng.choice([-1, 1], 15), jax.numpy.int32))
        assert_projection_equal(state, bin_to_subs, sub_len)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from graal_tpu_torch.utils.dataset import write_synthetic_dataset

    d = str(tmp_path_factory.mktemp("ml") / "ds")
    write_synthetic_dataset(d, n_bins=90, n_contigs=3, contacts_scale=40.0, seed=6)
    return d


def test_projection_of_a_jax_assembly_matches(dataset, tmp_path):
    from graal_tpu.config import RunConfig
    from graal_tpu.pipeline import Runner

    cfg = RunConfig(dataset_dir=dataset, output_dir=str(tmp_path / "o"), platform="cpu")
    cfg.pyramid.size, cfg.sampler.level, cfg.sampler.n_cycles = 3, 2, 2
    cfg.sampler.sample_param = False
    runner = Runner(cfg)
    asm = runner.run_em(progress=False)
    assert int(asm.state.n_contigs()) < asm.state.n_frags     # an assembled genome
    got = assert_projection_equal(asm.state, runner.pyramid.sub_ranges(2),
                                  runner.pyramid.get_level(1).genome_soa()["len_bp"])
    assert len(got["pos"]) == runner.pyramid.get_level(1).n_frags
    assert isinstance(asm.state, JState)


def test_run_multilevel(dataset, tmp_path):
    from graal_tpu_torch.config import RunConfig

    cfg = RunConfig(dataset_dir=dataset, output_dir=str(tmp_path / "out"), device="cpu")
    cfg.pyramid.size = 3
    cfg.sampler.n_cycles = 3
    cfg.sampler.sample_param = False
    runner, assembly = tml.run_multilevel(cfg, from_level=2, to_level=1, progress=False)
    check_invariants(assembly.state)
    assert assembly.state.n_frags == runner.pyramid.get_level(1).n_frags
    lls = assembly.metrics["likelihood"]
    assert lls[-1] > lls[0] - 1e-6
    (l2, r2, a2, w2), (l1, r1, a1, warm) = runner.levels
    assert (l2, l1) == (2, 1) and w2 is None and r1 is runner
    check_invariants(warm)
    # the warm start scores above the scrambled level-1 genome
    from graal_tpu_torch.core import mcmc

    one = TState(*[x[None] for x in warm])
    ex = TState(*[x[None] for x in mcmc.explode_genome(warm)])
    assert float(r1.score(one, r1.params)[0]) > float(r1.score(ex, r1.params)[0])
    with pytest.raises(ValueError):
        tml.run_multilevel(cfg, from_level=1, to_level=2)


def test_scale_run_multilevel(dataset):
    from graal_tpu_torch import scale

    final, runner, lev, per_level = scale.run_multilevel(
        dataset, 3, 2, 1, n_cycles=1, f_max_min=32, seed=3, progress=False, device="cpu")
    check_invariants(final)
    assert [m["level"] for m in per_level] == [2, 1]
    assert final.n_frags == lev.n_frags
    for m in per_level:
        assert np.isfinite(m["likelihood"][-1])
        assert set(m["launches"]) == {"ll_mini", "obsgrid"}
