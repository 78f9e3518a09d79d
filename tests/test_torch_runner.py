"""Parity of the port's assembly runner (graal_tpu_torch.pipeline.Runner and
scale.from_dataset) with the JAX package, on the CPU.

- ``Runner`` set-up, with and without blacklist, ``sub_sample_factor``
  and ``allow_repeats`` (on a dataset with one fragment's contacts
  amplified, tests/test_pipeline.py's recipe): bin matrix, observed map,
  mean trans value, table, neighbour table, duplications, distance
  references and the fitted params equal the JAX ``Runner``'s.
- ``run_em`` full and delta: the likelihood rises, the invariants hold and
  the outputs are written.
- Two cycles equal one cycle plus a resume, bit for bit (state, params,
  series, generator state): ``run_em`` full and delta, ``ScaleRunner.run``.
- ``scan_parameter`` and ``probe_fragment`` equal the JAX ones at rtol
  1e-5 on the same state and the same neighbour draw;
  ``polish_orientations`` is bit-exact.
- ``scale.from_dataset``'s table, observed map, params, neighbour table
  and duplications equal the JAX ones.
"""

import filecmp
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from graal_tpu import scale as jscale
from graal_tpu.config import RunConfig as JConfig
from graal_tpu.pipeline import Runner as JRunner
from graal_tpu.utils.dataset import write_synthetic_dataset
from graal_tpu_torch import scale as tscale
from graal_tpu_torch.config import RunConfig as TConfig
from graal_tpu_torch.core.state import check_invariants
from graal_tpu_torch.pipeline import Runner as TRunner
from tests.test_torch_pipeline import assert_tables_equal
from tests.test_torch_sparse import assert_sparse_equal
from tests.test_torch_state import assert_states_equal, to_port

RTOL = 1e-5
NB_FIELDS = ("xk", "pk", "dispatcher", "blacklist")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trun") / "ds")
    write_synthetic_dataset(d, n_bins=90, n_contigs=3, contacts_scale=40.0, seed=3)
    return d


@pytest.fixture(scope="module")
def repeat_dataset(dataset, tmp_path_factory):
    """The dataset with fragment 41's raw contacts amplified tenfold."""
    d = str(tmp_path_factory.mktemp("trun_rep") / "ds")
    shutil.copytree(dataset, d, ignore=shutil.ignore_patterns("pyramids"))
    pairs = os.path.join(d, "abs_fragments_contacts_weighted.txt")
    with open(pairs) as fh:
        lines = fh.readlines()
    extra = [ln for ln in lines[1:] if "41" in ln.split("\t")[:2]] * 9
    with open(pairs, "a") as fh:
        fh.writelines(extra)
    return d


def configs(dataset, out, **sampler):
    """The same configuration for both packages (level 1 of 3)."""
    out_cfgs = []
    for cls, extra in ((JConfig, dict(platform="cpu")), (TConfig, dict(device="cpu"))):
        cfg = cls(dataset_dir=dataset, output_dir=str(out / cls.__module__), **extra)
        cfg.pyramid.size = 3
        cfg.sampler.level = 1
        cfg.sampler.n_cycles = 2
        cfg.sampler.n_neighbours = 3
        cfg.sampler.sample_param = False
        for k, v in sampler.items():
            setattr(cfg.sampler, k, v)
        out_cfgs.append(cfg)
    return out_cfgs


def runners(dataset, out, **sampler):
    jc, tc = configs(dataset, out, **sampler)
    return JRunner(jc), TRunner(tc)


def assert_nb_equal(tnb, jnb):
    for f in NB_FIELDS:
        np.testing.assert_array_equal(getattr(tnb, f).numpy(), np.asarray(getattr(jnb, f)),
                                      err_msg=f)
    assert (tnb.n_bins, tnb.max_copies) == (jnb.n_bins, jnb.max_copies)


SETUPS = {
    "plain": dict(),
    "blacklist": dict(blacklist_contigs=(1,)),
    "sub_sample": dict(sub_sample_factor=0.5),
    "repeats": dict(allow_repeats=True),
}


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_runner_setup_matches_jax(dataset, repeat_dataset, tmp_path, name):
    ds = repeat_dataset if name == "repeats" else dataset
    jr, tr = runners(ds, tmp_path, **SETUPS[name])
    np.testing.assert_array_equal(tr.bin_matrix, jr.bin_matrix)
    np.testing.assert_array_equal(tr.obs, jr.obs)
    assert tr.mean_value_trans == jr.mean_value_trans
    assert_tables_equal(tr.table, jr.table)
    assert_nb_equal(tr.nb, jr.nb)
    assert_states_equal(tr.state, jr.state)
    assert tr.duplications == jr.duplications and tr.blacklisted == jr.blacklisted
    for f in ("dist_skip", "orientable", "init_prev", "init_next", "init_ori", "bin_to_subs"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f), err_msg=f)
    assert tr.params.astuple_np() == jr.params.astuple_np()
    for f in ("fit_bins", "fit_contacts", "fit_estim"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f), err_msg=f)
    assert tr.scorer is None                     # the plain likelihood on the CPU
    if name == "repeats":
        assert tr.duplications and tr.table.has_repeats
    if name == "blacklist":
        assert tr.blacklisted and tr.nb.blacklist.any()


@pytest.mark.parametrize("scoring", ["full", "delta"])
def test_run_em_assembles_and_writes_outputs(dataset, tmp_path, scoring):
    _, tc = configs(dataset, tmp_path, sample_param=True)
    runner = TRunner(tc)
    asm = runner.run_em(progress=False, scoring=scoring)
    lik = asm.metrics["likelihood"]
    assert lik[-1] > lik[0], (lik[0], lik[-1])
    check_invariants(asm.state)
    n = runner.state.n_frags
    assert len(lik) == 2 * n and len(asm.metrics["dist_init_genome"]) == 2 * n
    runner.save_behaviour(asm)
    runner.export_fasta(asm, os.path.join(dataset, "genome.fa"))
    out = tc.output_dir
    for f in ("0list_likelihood.txt", "0list_mutations.txt", "params.json", "genome.fasta",
              "info_frags.txt", "assembly_stats.json", "checkpoint.npz"):
        assert os.path.exists(os.path.join(out, f)), f
    if scoring == "delta":
        assert len(asm.metrics["anchor"]) == 2
        # the plain versions served the run: no CUDA launch on the CPU
        assert runner.mini_grid.n_launches == runner.obs_grid.n_launches == 0


def assert_checkpoints_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("scoring", ["full", "delta"])
def test_resume_equals_uninterrupted_run(dataset, tmp_path, scoring):
    outs = []
    for cycles in ((2,), (1, 2)):
        _, tc = configs(dataset, tmp_path / str(len(cycles)), sample_param=True)
        for k, n_cycles in enumerate(cycles):
            runner = TRunner(tc)
            asm = runner.run_em(n_cycles=n_cycles, progress=False, scoring=scoring,
                                resume=k > 0)
        runner.save_behaviour(asm)
        outs.append((tc.output_dir, asm))
    (out_a, asm_a), (out_b, asm_b) = outs
    assert_checkpoints_equal(os.path.join(out_a, "checkpoint.npz"),
                             os.path.join(out_b, "checkpoint.npz"))
    assert all(torch.equal(x, y) for x, y in zip(asm_a.state, asm_b.state))
    assert asm_a.params.astuple_np() == asm_b.params.astuple_np()
    assert asm_a.metrics == asm_b.metrics
    for f in os.listdir(out_a):
        if f.startswith("0list") or f == "params.json":
            assert filecmp.cmp(os.path.join(out_a, f), os.path.join(out_b, f),
                               shallow=False), f


def test_scale_runner_resume_equals_uninterrupted_run(tmp_path):
    from graal_tpu_torch import entry as tentry

    truth, shuf, table, params, sobs = tentry.scale_problem(
        120, n_contigs=2, n_pieces=8, seed=41, shuffle_seed=42, device="cpu")
    kw = dict(steps_per_cycle=40, f_max_min=32, sample_param=True, seed=9, progress=False,
              init_truth=truth)
    path_a, path_b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    fa, pa, ma = tscale.ScaleRunner(table, sobs, params).run(
        shuf, n_cycles=2, checkpoint_path=path_a, **kw)
    tscale.ScaleRunner(table, sobs, params).run(shuf, n_cycles=1, checkpoint_path=path_b, **kw)
    fb, pb, mb = tscale.ScaleRunner(table, sobs, params).run(
        shuf, n_cycles=2, checkpoint_path=path_b, resume=True, **kw)
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert pa.astuple_np() == pb.astuple_np()
    ma.pop("cycle_s"), mb.pop("cycle_s")
    assert ma == mb
    with np.load(path_a) as x, np.load(path_b) as y:
        for k in x.files:
            if k != "extra_m_cycle_s":
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_probe_and_scan_match_jax(dataset, tmp_path):
    jr, tr = runners(dataset, tmp_path)
    # the same state in both: a few committed mutations from the file order
    from graal_tpu.core import mcmc as jm

    js = jm.explode_genome(jr.state)
    for fa, fb, op in ((0, 1, 6), (1, 2, 6), (5, 9, 3), (12, 4, 1)):
        js = jm.apply_mutation(js, fa, fb, op)
    jr.state = js
    tr.state = to_port(js)
    ids_j, valid_j, ll_j = jr.probe_fragment(5)
    u = np.asarray(jax.random.uniform(jax.random.key(0), (tr.nb.pk.shape[1],)))
    ids_t, valid_t, ll_t = tr.probe_fragment(5, u=u)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(valid_t, valid_j)
    np.testing.assert_allclose(ll_t, ll_j, rtol=RTOL)
    for name, values in (("slope", [-1.8, -1.5, -1.2]), ("d_max", [20.0, 60.0]),
                         ("v_inter", [0.01, 0.1])):
        np.testing.assert_allclose(tr.scan_parameter(name, values),
                                   jr.scan_parameter(name, values), rtol=RTOL)
    with pytest.raises(ValueError):
        tr.scan_parameter("nope", [1.0])


def test_polish_orientations_bit_exact(dataset, tmp_path):
    import jax.numpy as jnp

    jr, tr = runners(dataset, tmp_path)
    s = jr.state.to_numpy()
    rng = np.random.default_rng(0)
    ori = np.where(s["id_c"] == 0, -1, 1).astype(np.int32)
    ori = np.where(jr.orientable, ori, rng.choice([-1, 1], len(ori))).astype(np.int32)
    noisy_j = jr.state._replace(ori=jnp.asarray(ori))
    assert_states_equal(tr.polish_orientations(to_port(noisy_j)),
                        jr.polish_orientations(noisy_j))


@pytest.mark.parametrize("kw", [dict(), dict(allow_repeats=True), dict(sub_sample=0.5)])
def test_from_dataset_matches_jax(dataset, repeat_dataset, kw):
    ds = repeat_dataset if kw.get("allow_repeats") else dataset
    args = dict(level=1, max_fit_bins=64, progress=False, sub_sample_seed=3, **kw)
    jr, js0, jlev, jx = jscale.from_dataset(ds, 3, 3, **args)
    tr, ts0, tlev, tx = tscale.from_dataset(ds, 3, 3, device="cpu", **args)
    assert_tables_equal(tr.table, jr.table)
    assert_sparse_equal(tr.sobs, jr.sobs)
    assert tr.params.astuple_np() == jr.params.astuple_np()
    assert_nb_equal(tr.nb, jr.nb)
    assert_states_equal(ts0, js0)
    assert tx["duplications"] == jx["duplications"]
    assert tx["v_inter"] == jx["v_inter"]
    np.testing.assert_array_equal(tr.bin_norm, jr._bin_norm)
    np.testing.assert_array_equal(tr.bin_csr.toarray(), jr._bin_csr.toarray())
    assert (tr.w, tr.max_covered_d_max) == (jr.w, jr.max_covered_d_max)
    if kw.get("allow_repeats"):
        assert tx["duplications"] and tr.table.has_repeats
