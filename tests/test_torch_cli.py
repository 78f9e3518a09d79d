"""The port's CLI (graal_tpu_torch.cli) in this process, on the CPU.

- Every ported command (simulate, pyramid, run, replay, scale, probe) runs
  with ``--device cpu`` and writes its outputs; so do the sampler stages
  and options (``run --sampler em,mtm,mh``, ``--sampler tempered --chains
  3``, ``--to-level``, ``--model hic``, ``scale --mtm-cycles`` and ``scale
  --to-level``), each writing the files the JAX command writes;
  ``run --sampler em,mtm,mh`` writes the JAX run's files and series
  lengths.
- Without ``--device cpu``, on a box with no card, every sampling command
  and stage exits non-zero: there is no silent CPU run.
- No option is refused any more: the ones that named a ROADMAP item (A12:
  ``scale --chains`` / ``--t-max``; A13: the profiler, snapshots, live
  view) reach the run's configuration (they are driven end to end in
  ``tests/test_torch_host_utils.py`` and ``tests/test_torch_run_chains.py``).
- ``scale --chains N`` hands ``--steps-per-cycle`` to ``run_chains``
  (the JAX command drops it there; ROADMAP §C).
- The whole-run comparison: a JAX ``cli run --platform cpu`` writes its
  mutation log; the port's ``replay`` of that log gives the JAX replay's
  final state bit for bit and its likelihood at rtol 1e-5, and a
  ``genome.fasta`` byte-identical to the JAX run's.
"""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from graal_tpu import cli as jcli
from graal_tpu_torch import cli as tcli
from tests.test_torch_state import assert_states_equal

RTOL = 1e-5


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tcli") / "ds")
    assert tcli.main(["simulate", d, "--bins", "96", "--contigs", "3", "--seed", "5"]) == 0
    return d


def run_args(ds, out, *extra):
    return ["run", ds, "--size", "3", "--level", "1", "--out", out,
            "--fasta", os.path.join(ds, "genome.fa"), *extra]


def test_commands_run_on_cpu(ds, tmp_path, capsys):
    pyr = tcli.execute(["pyramid", ds, "--size", "3"])
    assert pyr.get_level(1).n_frags > 10
    out = str(tmp_path / "run")
    assert tcli.main(run_args(ds, out, "--cycles", "2", "--device", "cpu", "--polish")) == 0
    for f in ("genome.fasta", "0list_likelihood.txt", "0list_mutations.txt", "params.json",
              "checkpoint.npz", "assembly_stats.json"):
        assert os.path.exists(os.path.join(out, f)), f
    runner, state, ll = tcli.execute(["replay", ds, os.path.join(out, "0list_mutations.txt"),
                                      "--size", "3", "--level", "1", "--device", "cpu",
                                      "--out", str(tmp_path / "replay")])
    assert np.isfinite(float(ll)) and state.pos.device.type == "cpu"
    oscale = str(tmp_path / "scale")
    runner, final, m = tcli.execute(["scale", ds, "--size", "3", "--level", "1", "--cycles",
                                     "1", "--out", oscale, "--device", "cpu", "--f-max-min",
                                     "64", "--fasta", os.path.join(ds, "genome.fa")])
    for f in ("genome.fasta", "0list_likelihood.txt", "0list_f_max.txt", "checkpoint.npz"):
        assert os.path.exists(os.path.join(oscale, f)), f
    tail = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert np.isfinite(json.loads(tail[-1])["final_loglik"])
    _, ids, valid, ll = tcli.execute(["probe", ds, "3", "--size", "3", "--level", "1",
                                      "--device", "cpu", "--out", str(tmp_path / "probe")])
    assert ll.shape == (len(ids), 13) and np.isfinite(ll[valid]).all()


def level2_args(ds, out, *extra):
    return ["run", ds, "--size", "3", "--level", "2", "--out", out,
            "--fasta", os.path.join(ds, "genome.fa"), *extra]


def scale_args(ds, out, *extra):
    return ["scale", ds, "--size", "3", "--level", "1", "--cycles", "1", "--out", out,
            "--f-max-min", "32", "--fasta", os.path.join(ds, "genome.fa"), *extra]


@pytest.mark.parametrize("command", ["run", "scale", "replay", "run_mtm", "run_tempered",
                                     "run_to_level", "run_hic", "scale_mtm",
                                     "scale_to_level"])
def test_default_device_is_the_card(ds, tmp_path, command):
    o = str(tmp_path / "o")
    argv = {"run": run_args(ds, o, "--cycles", "1"),
            "scale": ["scale", ds, "--size", "3", "--level", "1", "--cycles", "1",
                      "--out", o],
            "replay": ["replay", ds, str(tmp_path / "none.txt"), "--size", "3", "--level",
                       "1", "--out", o],
            "run_mtm": run_args(ds, o, "--cycles", "1", "--sampler", "em,mtm,mh"),
            "run_tempered": run_args(ds, o, "--sampler", "tempered"),
            "run_to_level": level2_args(ds, o, "--to-level", "1"),
            "run_hic": run_args(ds, o, "--model", "hic"),
            "scale_mtm": scale_args(ds, o, "--mtm-cycles", "1"),
            "scale_to_level": scale_args(ds, o, "--level", "2", "--to-level", "1")}[command]
    if torch.cuda.is_available():
        assert tcli.parser().parse_args(argv).device == "cuda"
        return
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code not in (0, None) and "cuda" in str(e.value.code)
    assert not os.path.exists(os.path.join(str(tmp_path / "o"), "checkpoint.npz"))


FORMERLY_REFUSED = [["--profile"], ["--snapshots"], ["--snapshot-every", "2"], ["--watch"]]
SCALE_FORMERLY_REFUSED = [["--chains", "2"], ["--t-max", "2.0"], ["--profile"],
                          ["--snapshot-every", "2"], ["--watch"]]


@pytest.mark.parametrize("command", ["run", "replay", "probe", "scale"])
def test_refused_options_name_their_roadmap_item(ds, tmp_path, command):
    """The options that were refused with their ROADMAP item (A12, A13)
    are accepted now and reach the run: the CLI has no refusal left."""
    assert not hasattr(tcli, "refuse")
    out = str(tmp_path / "o")
    base = {"run": run_args(ds, out), "scale": ["scale", ds, "--out", out],
            "replay": ["replay", ds, "log.txt", "--out", out],
            "probe": ["probe", ds, "3", "--out", out]}[command]
    for extra in SCALE_FORMERLY_REFUSED if command == "scale" else FORMERLY_REFUSED:
        args = tcli.parser().parse_args(base + extra + ["--device", "cpu"])
        if command == "scale":
            got = {"--chains": args.chains, "--t-max": args.t_max, "--profile": args.profile,
                   "--snapshot-every": args.snapshot_every, "--watch": args.watch}[extra[0]]
            assert got == ({"--chains": 2, "--t-max": 2.0, "--snapshot-every": 2}
                           .get(extra[0], True)), extra
            continue
        cfg = tcli._checked_config(args)
        assert cfg.device == "cpu"
        got = {"--profile": args.profile, "--snapshots": args.snapshots,
               "--snapshot-every": cfg.sampler.snapshot_every,
               "--watch": cfg.sampler.watch}[extra[0]]
        assert got == (2 if extra[0] == "--snapshot-every" else True), extra
    assert not os.path.exists(out)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("steps", [None, 7])
def test_scale_chains_forwards_steps_per_cycle(ds, tmp_path, monkeypatch, steps):
    """``scale --chains N`` hands ``--steps-per-cycle`` to ``run_chains``;
    without the flag the chains sweep every fragment, as the JAX command's
    do (it drops the flag under ``--chains``: ROADMAP §C)."""
    from graal_tpu_torch import scale as tscale

    seen = {}

    def fake(self, state, **kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(tscale.ScaleRunner, "run_chains", fake)
    extra = [] if steps is None else ["--steps-per-cycle", str(steps)]
    with pytest.raises(_Stop):
        tcli.execute(scale_args(ds, str(tmp_path / "o"), "--chains", "2", "--device", "cpu",
                                *extra))
    assert seen["steps_per_cycle"] == steps and seen["n_chains"] == 2


SERIES = ["0list_likelihood.txt", "0list_n_contigs.txt", "0list_dist_init_genome.txt",
          "0list_fact.txt", "0list_slope.txt", "0list_d_max.txt", "0list_d_nuc.txt",
          "0list_success.txt", "0list_mean_len.txt", "0list_mutations.txt", "params.json"]
FASTA = ["genome.fasta", "info_frags.txt", "assembly_stats.json"]
SCALE_SERIES = ["0list_likelihood.txt", "0list_n_contigs.txt", "0list_dist_init_genome.txt",
                "0list_overflow.txt", "0list_f_max.txt", "0list_fact.txt", "0list_slope.txt",
                "0list_d_max.txt", "0list_d_nuc.txt"]


def assert_outputs(out, names):
    missing = [f for f in names if not os.path.exists(os.path.join(out, f))]
    assert not missing, missing


def test_sampler_stages_run_on_cpu(ds, tmp_path):
    """Tempered chains, multilevel refinement and the HiC model through the
    CLI, with the JAX commands' output files."""
    from graal_tpu_torch.core.model_hic import HiCParams
    from graal_tpu_torch.core.state import check_invariants

    out = str(tmp_path / "tempered")
    runner, asm = tcli.execute(run_args(ds, out, "--sampler", "tempered", "--chains", "3",
                                        "--cycles", "2", "--device", "cpu"))
    assert runner.chain_states.pos.shape[0] == 3 and len(asm.metrics["swap_accepts"]) == 2
    assert_outputs(out, SERIES + FASTA)
    check_invariants(asm.state)

    out = str(tmp_path / "multilevel")
    runner, asm = tcli.execute(level2_args(ds, out, "--to-level", "1", "--cycles", "1",
                                           "--device", "cpu"))
    assert [lv[0] for lv in runner.levels] == [2, 1]
    assert asm.state.n_frags == runner.pyramid.get_level(1).n_frags
    assert_outputs(out, SERIES + FASTA + ["checkpoint.npz"])

    out = str(tmp_path / "hic")
    runner, asm = tcli.execute(run_args(ds, out, "--model", "hic", "--cycles", "1",
                                        "--device", "cpu"))
    assert isinstance(asm.params, HiCParams) and not runner.sample_param
    assert_outputs(out, SERIES + FASTA + ["checkpoint.npz"])


def test_scale_mtm_and_multilevel_run_on_cpu(ds, tmp_path, capsys):
    out = str(tmp_path / "scale_mtm")
    runner, final, m = tcli.execute(scale_args(ds, out, "--mtm-cycles", "1",
                                               "--steps-per-cycle", "32", "--device", "cpu"))
    assert len(m["mtm"]["likelihood"]) == 1 and len(m["likelihood"]) == 2
    assert_outputs(out, SCALE_SERIES + FASTA + ["checkpoint.npz"])
    out = str(tmp_path / "scale_ml")
    runner, final, per_level = tcli.execute(scale_args(ds, out, "--level", "2", "--to-level",
                                                       "1", "--steps-per-cycle", "32",
                                                       "--device", "cpu"))
    assert [lv["level"] for lv in per_level] == [2, 1]
    assert_outputs(out, FASTA)
    tail = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith('{"levels"')]
    assert all(np.isfinite(lv["final_loglik"]) for lv in json.loads(tail[-1])["levels"])


def test_em_mtm_mh_writes_the_jax_runs_files(ds, tmp_path):
    """``run --sampler em,mtm,mh``: per stage the carried likelihood is the
    final genome's, and the outputs are the JAX run's files with its series
    lengths."""
    from graal_tpu_torch.core.likelihood import log_likelihood
    from graal_tpu_torch.core.state import GenomeState as TState

    tout = str(tmp_path / "port")
    runner, asm = tcli.execute(run_args(ds, tout, "--cycles", "1", "--sampler", "em,mtm,mh",
                                        "--device", "cpu"))
    assert [st["name"] for st in runner.stages] == ["em", "mtm", "mh"]
    obs = torch.as_tensor(runner.obs)
    for st in runner.stages:
        one = TState(*[x[None] for x in st["assembly"].state])
        want = float(log_likelihood(one, runner.table, obs, st["assembly"].params)[0])
        np.testing.assert_allclose(float(st["l_t"]), want, rtol=RTOL, err_msg=st["name"])
    jout = str(tmp_path / "jax")
    assert jcli.main(run_args(ds, jout, "--cycles", "1", "--sampler", "em,mtm,mh",
                              "--platform", "cpu")) == 0
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    for f in SERIES[:-1]:
        with open(os.path.join(tout, f)) as a, open(os.path.join(jout, f)) as b:
            assert len(a.readlines()) == len(b.readlines()), f


def test_replay_of_a_jax_run_matches_jax(ds, tmp_path):
    """The JAX run's mutation log, replayed by both packages."""
    from graal_tpu.config import RunConfig
    from graal_tpu.core import mcmc as jm
    from graal_tpu.core.likelihood import log_likelihood
    from graal_tpu.pipeline import Runner

    jout = str(tmp_path / "jax_run")
    assert jcli.main(run_args(ds, jout, "--cycles", "2", "--platform", "cpu")) == 0
    log = os.path.join(jout, "0list_mutations.txt")
    # the JAX replay (graal_tpu.cli.cmd_replay's steps)
    cfg = RunConfig(dataset_dir=ds, output_dir=str(tmp_path / "jax_replay"), platform="cpu")
    cfg.pyramid.size, cfg.sampler.level = 3, 1
    runner = Runner(cfg)
    state = jm.explode_genome(runner.state)
    muts = np.loadtxt(log, dtype=np.int64, skiprows=1, ndmin=2)
    apply = jax.jit(jm.apply_mutation)
    for fa, fb, op in muts:
        if op >= 0:
            state = apply(state, int(fa), int(fb), int(op))
    ll_j = float(log_likelihood(state, runner.table, runner.obs, runner.params))
    # the port's replay
    tout = str(tmp_path / "port_replay")
    _, tstate, ll_t = tcli.execute(["replay", ds, log, "--size", "3", "--level", "1",
                                    "--device", "cpu", "--fasta",
                                    os.path.join(ds, "genome.fa"), "--out", tout])
    assert_states_equal(tstate, state)
    np.testing.assert_allclose(float(ll_t), ll_j, rtol=RTOL)
    assert filecmp.cmp(os.path.join(jout, "genome.fasta"), os.path.join(tout, "genome.fasta"),
                       shallow=False)
