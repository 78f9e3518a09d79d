"""The host utilities (utils/live.py, utils/plots.py, utils/profiling.py)
and the snapshot, watch and profile branches of the Runner, ScaleRunner
and the CLI, on the CPU.

- ``live_status.json`` and ``live_particles.json`` are byte for byte the
  JAX package's for the same state and stats (a repeat-expanded genome
  with an inactive copy, and a strided chr1-scale genome), and so is the
  page.
- ``Runner.save_matrix_snapshot``'s ``.npy`` is byte for byte the JAX
  Runner's for the same genome on the same dataset.
- ``bandwidth_report``'s arithmetic: the strict upper triangle and the
  candidate vectors a step, against the H100's 3.35 TB/s.
- ``trace`` writes a Chrome trace that names the ops it saw.
- Without matplotlib every figure function returns None (the reference's
  own behaviour, and the card's machine has none); with it they write
  their files.
- The CLI: ``run --watch --snapshots --snapshot-every 1 --profile`` (port
  of tests/test_cli.py::test_watch_live_view and
  tests/test_pipeline.py::test_matrix_snapshot) and ``scale --watch
  --snapshot-every 1 --profile`` write the live page and its JSON files,
  the snapshots, the layout paintings and the profiler trace.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graal_tpu.core.state import GenomeState as JState
from graal_tpu.utils import live as jlive
from graal_tpu_torch import cli as tcli
from graal_tpu_torch.utils import live as tlive
from graal_tpu_torch.utils import plots as tplots
from graal_tpu_torch.utils import profiling as tprof
from tests.test_torch_state import to_port


def repeat_genome(n=40):
    rng = np.random.default_rng(3)
    soa = dict(pos=np.arange(n) % 10, id_c=np.arange(n) // 10, start_bp=(np.arange(n) % 10) * 100,
               len_bp=np.full(n, 100), circ=np.zeros(n), l_cont=np.full(n, 10),
               l_cont_bp=np.full(n, 1000), ori=rng.choice([-1, 1], n), rep=np.zeros(n),
               activ=np.ones(n), id_d=np.concatenate([np.arange(n - 2), [5, 17]]))
    soa["activ"][n - 1] = 0
    return JState.from_soa(soa)


@pytest.mark.parametrize("kind", ["repeat_inactive", "strided"])
def test_live_files_byte_identical_to_jax(tmp_path, kind):
    if kind == "strided":
        n = 50_000
        j_state = JState.from_soa(dict(
            pos=np.zeros(n), id_c=np.arange(n), start_bp=np.zeros(n), len_bp=np.full(n, 100),
            circ=np.zeros(n), l_cont=np.ones(n), l_cont_bp=np.full(n, 100), ori=np.ones(n),
            rep=np.zeros(n), activ=np.ones(n), id_d=np.arange(n)))
        chrom = np.arange(n) % 7
    else:
        j_state = repeat_genome()
        chrom = np.arange(38) % 3
    stats = {"cycle": 3, "loglik": -12345.678912, "n_contigs": 4, "dist": 0.123456789,
             "T": 1.0, "f_max": 256}
    series = [-20000.5, -15000.25, -12345.678912]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jlive.update(jd, stats, series, state=j_state, chrom_of_bin=chrom)
    tlive.update(td, stats, series, state=to_port(j_state), chrom_of_bin=chrom)
    for f in ("live_status.json", "live_particles.json", "live.html"):
        with open(os.path.join(jd, f), "rb") as a, open(os.path.join(td, f), "rb") as b:
            assert a.read() == b.read(), f
    parts = json.load(open(os.path.join(td, "live_particles.json")))
    assert len(parts["id_c"]) <= 20_000
    assert ("active" in parts) == (kind == "repeat_inactive")


def test_bandwidth_report_arithmetic():
    t = tprof.dense_scorer_traffic(1152, 65, 384)
    per_step = 4 * (1152 * 1151 // 2) + 4 * (4 * 65 * 1152 + 3 * 1152 + 65)
    assert t == {"per_step_bytes": per_step, "per_cycle_bytes": per_step * 384}
    rep = tprof.bandwidth_report(1152, 65, 384, 2.0)
    gbps = per_step * 384 / 2.0 / 1e9
    assert rep["achieved_gb_per_s"] == round(gbps, 2)
    assert rep["fraction_of_peak"] == round(gbps * 1e9 / 3.35e12, 6)
    assert rep["traffic_gb"] == round(per_step * 384 / 1e9, 4)
    assert tprof.bandwidth_report(10, 1, 1, 1.0, peak_bytes_per_s=1e9)["fraction_of_peak"] == \
        round(tprof.dense_scorer_traffic(10, 1, 1)["per_cycle_bytes"] / 1e9, 6)


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with tprof.trace(d):
        torch.log(torch.rand(64, 64) + 1.0).sum()
    with open(os.path.join(d, "trace.json")) as fh:
        text = fh.read()
    assert "aten::log" in text and json.loads(text)["traceEvents"]


def test_figures_need_matplotlib_or_return_none(tmp_path, monkeypatch):
    state = to_port(repeat_genome())
    out = str(tmp_path)
    for name, col in (("0list_likelihood.txt", [-3.0, -2.0, -1.0]),
                      ("0list_n_contigs.txt", [9, 5, 4])):
        np.savetxt(os.path.join(out, name), col)
    np.save(os.path.join(out, "snapshot_0001.npy"), np.eye(8))
    np.save(os.path.join(out, "snapshot_0002.npy"), np.ones((8, 8)))
    chrom = np.arange(38) % 3
    assert os.path.exists(tplots.plot_genome_layout(state, chrom, out))
    assert os.path.exists(tplots.summarize_run(out))
    assert os.path.exists(tplots.animate_snapshots(out))
    assert tplots.main([out]) == 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tplots.plot_genome_layout(state, chrom, out, out_name="x.png") is None
    assert tplots.summarize_run(out, out_name="y.png") is None
    assert tplots.animate_snapshots(out, out_name="z.gif") is None
    assert not any(os.path.exists(os.path.join(out, f)) for f in ("x.png", "y.png", "z.gif"))


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hostutils") / "ds")
    tcli.main(["simulate", d, "--bins", "60", "--contigs", "2", "--seed", "4"])
    return d


def test_matrix_snapshot_byte_identical_to_jax(ds, tmp_path):
    from graal_tpu.config import RunConfig as JConfig
    from graal_tpu.pipeline import Runner as JRunner
    from graal_tpu_torch.config import RunConfig
    from graal_tpu_torch.pipeline import Runner

    def cfg(cls, out):
        c = cls()
        c.dataset_dir, c.output_dir = ds, out
        c.pyramid.size, c.sampler.level = 3, 1
        return c

    jr = JRunner(cfg(JConfig, str(tmp_path / "j")))
    c = cfg(RunConfig, str(tmp_path / "t"))
    c.device = "cpu"
    tr = Runner(c)
    rng = np.random.default_rng(0)
    shuffled = np.asarray(jr.state.id_c).copy()
    rng.shuffle(shuffled)
    j_state = jr.state._replace(id_c=jnp.asarray(shuffled))
    j_state = j_state._replace(activ=j_state.activ.at[3].set(0))
    for name, st in (("snap_a", jr.state), ("snap_b", j_state)):
        a = jr.save_matrix_snapshot(name, st)
        b = tr.save_matrix_snapshot(name, to_port(st))
        with open(a + ".npy", "rb") as fa, open(b + ".npy", "rb") as fb:
            assert fa.read() == fb.read(), name
        m = np.load(b + ".npy")
        assert m.shape[0] == m.shape[1] > 0


def test_cli_run_watch_snapshots_profile(ds, tmp_path):
    out = str(tmp_path / "out")
    runner, assembly = tcli.execute(["run", ds, "--size", "3", "--level", "1", "--cycles", "2",
                                     "--out", out, "--device", "cpu", "--watch", "--snapshots",
                                     "--snapshot-every", "1", "--profile"])
    with open(os.path.join(out, "live_status.json")) as fh:
        status = json.load(fh)
    assert status["stats"]["cycle"] == 1 and len(status["likelihood"]) > 1
    assert os.path.exists(os.path.join(out, "layout_latest.png"))
    parts = json.load(open(os.path.join(out, "live_particles.json")))
    n = len(parts["id_c"])
    assert n > 0 and len(parts["pos"]) == n and len(parts["chrom"]) == n
    page = open(os.path.join(out, "live.html")).read()
    assert "live_particles.json" in page and "canvas" in page
    for f in ("pre_assembly.npy", "post_assembly.npy", "snapshot_0001.npy", "snapshot_0002.npy",
              "genome_layout.png", "profile/trace.json"):
        assert os.path.exists(os.path.join(out, f)), f
    m = np.load(os.path.join(out, "snapshot_0002.npy"))
    assert m.shape[0] == m.shape[1] > 0
    assert "em_cycle" in runner.timer.report()


@pytest.mark.parametrize("chains", [1, 3], ids=["run", "run_chains"])
def test_cli_scale_watch_snapshots_profile(ds, tmp_path, chains):
    out = str(tmp_path / "scale")
    runner, final, m = tcli.execute(["scale", ds, "--size", "3", "--level", "1", "--cycles",
                                     "2", "--steps-per-cycle", "48", "--f-max-min", "32",
                                     "--out", out, "--device", "cpu", "--watch",
                                     "--snapshot-every", "1", "--profile",
                                     "--chains", str(chains)])
    for f in ("live.html", "live_status.json", "live_particles.json", "layout_0001.png",
              "layout_0002.png", "layout_latest.png", "genome_layout.png",
              "profile/trace.json"):
        assert os.path.exists(os.path.join(out, f)), f
    status = json.load(open(os.path.join(out, "live_status.json")))
    assert status["stats"]["cycle"] == 1 and status["stats"]["f_max"] in m["f_max"]
