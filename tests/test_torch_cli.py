"""The port's CLI (graal_tpu_torch.cli) in this process, on the CPU.

- Every ported command (simulate, pyramid, run, replay, scale, probe) runs
  with ``--device cpu`` and writes its outputs.
- Without ``--device cpu``, on a box with no card, ``run`` exits non-zero:
  there is no silent CPU run.
- Every refused option names the ROADMAP item that ports it.
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


@pytest.mark.parametrize("command", ["run", "scale", "replay"])
def test_default_device_is_the_card(ds, tmp_path, command):
    argv = {"run": run_args(ds, str(tmp_path / "o"), "--cycles", "1"),
            "scale": ["scale", ds, "--size", "3", "--level", "1", "--cycles", "1",
                      "--out", str(tmp_path / "o")],
            "replay": ["replay", ds, str(tmp_path / "none.txt"), "--size", "3", "--level",
                       "1", "--out", str(tmp_path / "o")]}[command]
    if torch.cuda.is_available():
        assert tcli.parser().parse_args(argv).device == "cuda"
        return
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code not in (0, None) and "cuda" in str(e.value.code)
    assert not os.path.exists(os.path.join(str(tmp_path / "o"), "checkpoint.npz"))


REFUSED = [
    (["--model", "hic"], "A11"), (["--sampler", "em,mtm"], "A11"),
    (["--sampler", "tempered"], "A11"), (["--to-level", "0"], "A11"),
    (["--profile"], "A13"), (["--snapshots"], "A13"), (["--snapshot-every", "2"], "A13"),
    (["--watch"], "A13"),
]
SCALE_REFUSED = [
    (["--chains", "2"], "A12"), (["--mtm-cycles", "1"], "A11"), (["--to-level", "0"], "A11"),
    (["--profile"], "A13"), (["--snapshot-every", "2"], "A13"), (["--watch"], "A13"),
]


@pytest.mark.parametrize("command", ["run", "replay", "probe", "scale"])
def test_refused_options_name_their_roadmap_item(ds, tmp_path, command):
    out = str(tmp_path / "o")
    base = {"run": run_args(ds, out), "scale": ["scale", ds, "--out", out],
            "replay": ["replay", ds, "log.txt", "--out", out],
            "probe": ["probe", ds, "3", "--out", out]}[command]
    for extra, item in SCALE_REFUSED if command == "scale" else REFUSED:
        with pytest.raises(SystemExit) as e:
            tcli.main(base + extra + ["--device", "cpu"])
        assert f"ROADMAP {item}" in str(e.value.code), (extra, e.value.code)
    assert not os.path.exists(out)


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
