"""``parallel.sharding`` on ``torch.distributed``: gloo worlds of CPU
processes held to the one-process results.

Ports of tests/test_sharding.py's seven tests and of
tests/test_multihost.py's two-process likelihood. Each world (2 and 4
ranks, gloo, a FileStore in the test's temporary directory, no network)
is one launch of this file's :func:`_child` per rank, with a timeout of
120 s; every rank runs every check and reports its numbers, and each test
reads its check from every rank:

- the row-sharded dense likelihood (even and uneven rows, and the
  copy-summing repeat grid) at rtol 1e-5 from the one-process block
  likelihood over every row, and from ``core.likelihood.log_likelihood``
  (rtol 1e-5; repeats at the JAX test's rtol 5e-4, atol 0.5);
- the sharded EM step and the sharded delta cycle, chains over ranks and
  rows = 1, bit for bit the one-process chains-axis step and cycle (states,
  scores, carried likelihoods);
- the tempered cycle with its chains over ranks, bit for bit the
  one-process cycle;
- the sharded sparse anchor (four chain states with their own params on a
  (chains, rows) mesh) and its repeat twin (a deactivated copy included)
  at rtol 1e-6 from the one-process chains-axis anchor;
- the two-process likelihood of tests/test_multihost.py (and its
  four-process twin) within max(1, 1e-4 |L|) of the dense likelihood;
- every rank returns the same numbers.

In this process (no process group, a one-rank world) every sharded
function equals its one-process counterpart bit for bit, and the sharded
likelihood agrees with the JAX package's on its 8-device CPU mesh.
"""

import json
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

# one intra-op thread per test worker (and per rank of the worlds below)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# the checks every rank of a world runs
# ---------------------------------------------------------------------------

def _dense_problem():
    from graal_tpu_torch.entry import problem

    return problem(n_bins=36, n_contigs=4, seed=11, device="cpu")


def _scale_problem():
    from graal_tpu_torch.entry import scale_problem

    return scale_problem(200, n_contigs=2, n_pieces=10, seed=41, shuffle_seed=42, device="cpu")


def _states(states):
    from graal_tpu_torch.core.state import GenomeState

    return GenomeState(*[torch.stack(xs) for xs in zip(*states)])


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return all(_equal(x, y) for x, y in zip(a, b))


def check_world(world):
    from graal_tpu_torch.parallel import sharding

    out = {"world": sharding.world_size(), "rank": sharding.rank()}
    for shape in ((world, 1), (1, world), (2, world // 2)):
        m = sharding.make_mesh(*shape)
        out[f"{shape}"] = [m.chain_index, m.row_index]
    return out


def check_ll(world):
    from graal_tpu_torch.core.likelihood import log_likelihood
    from graal_tpu_torch.parallel import sharding

    state, table, params, obs, _ = _dense_problem()
    got = sharding.sharded_log_likelihood(sharding.make_mesh(1, world), table, obs)(state,
                                                                                    params)
    one = sharding._block_log_likelihood(state, table, torch.as_tensor(obs), params, 0).float()
    dense = log_likelihood(state, table, torch.as_tensor(obs), params)
    return {"got": float(got), "one": float(one), "dense": float(dense)}


def check_ll_uneven(world):
    from graal_tpu_torch.core.likelihood import log_likelihood
    from graal_tpu_torch.core.model import RippeParams
    from graal_tpu_torch.core.state import GenomeState
    from graal_tpu_torch.core.subfrags import trivial_table
    from graal_tpu_torch.parallel import sharding

    n, per = 10, 5
    state = GenomeState.from_soa(dict(
        pos=np.arange(n) % per, id_c=np.arange(n) // per, start_bp=(np.arange(n) % per) * 3000,
        len_bp=np.full(n, 3000), circ=np.zeros(n), l_cont=np.full(n, per),
        l_cont_bp=np.full(n, per * 3000), ori=np.ones(n), rep=np.zeros(n), activ=np.ones(n),
        id_d=np.arange(n)))
    table = trivial_table(np.full(n, 3000))
    params = RippeParams.create(kuhn=1.0, lm=9.6, slope=-1.5, d=3.0, fact=5000.0,
                                d_max=900.0, v_inter=0.1)
    obs = np.random.default_rng(0).poisson(2.0, (n, n)).astype(np.float32)
    obs = np.triu(obs, 1) + np.triu(obs, 1).T
    mesh = sharding.make_mesh(1, world)
    got = sharding.sharded_log_likelihood(mesh, table, obs)(state, params)
    one = sharding._block_log_likelihood(state, table, torch.as_tensor(obs), params, 0).float()
    dense = log_likelihood(state, table, torch.as_tensor(obs), params)
    return {"got": float(got), "one": float(one), "dense": float(dense)}


def check_ll_repeats(world):
    from graal_tpu_torch.core.likelihood import log_likelihood
    from graal_tpu_torch.entry import repeat_problem
    from graal_tpu_torch.parallel import sharding

    state, table, params, obs, _ = repeat_problem(n_bins=24, n_contigs=3, n_dups=3, seed=12,
                                                  device="cpu")
    assert table.has_repeats
    got = sharding.sharded_log_likelihood(sharding.make_mesh(1, world), table, obs)(state,
                                                                                    params)
    one = sharding._block_log_likelihood(state, table, torch.as_tensor(obs), params, 0).float()
    dense = log_likelihood(state, table, torch.as_tensor(obs), params)
    return {"got": float(got), "one": float(one), "dense": float(dense)}


def check_em_step(world):
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.core.state import check_invariants
    from graal_tpu_torch.parallel import sharding, tempering

    state, table, params, obs, nb = _dense_problem()
    c = world
    states = _states([mcmc.explode_genome(state)] * c)
    f_as = torch.tensor([3, 7, 20, 33][:c])
    step = sharding.make_sharded_em_step(sharding.make_mesh(c, 1), table, obs, nb, delta=3)
    new, (score, op, fb) = step(states, torch.Generator().manual_seed(0), params, f_as, 1.0)
    obs_t = torch.as_tensor(obs)

    def one_scorer(s, p):
        return sharding._block_log_likelihood(s, table, obs_t, p, 0).float()

    one = mcmc.make_em_step(table, obs, nb, 3, scorer=one_scorer)
    draws = tempering.draw_chain_inputs(torch.Generator().manual_seed(0), nb, 3, c)
    want = one(states, draws, params, f_as, 1.0)
    for k in range(c):
        check_invariants(type(new)(*[x[k] for x in new]))
    rescored = one_scorer(type(new)(*[x[0:1] for x in new]), params)[0]
    return {"equal": _equal(new, want[0]) and _equal((score, op, fb), want[1]),
            "score0": float(score[0]), "rescored0": float(rescored),
            "moved": int((op >= 0).sum())}


def check_delta_cycle(world):
    from graal_tpu_torch.core import delta, mcmc
    from graal_tpu_torch.core.model import RippeParams
    from graal_tpu_torch.parallel import sharding
    from graal_tpu_torch.parallel.tempering import temperature_ladder
    from graal_tpu_torch.scale import ScaleRunner

    truth, shuf, table, params, sobs = _scale_problem()
    r = ScaleRunner(table, sobs, params)
    c = 4
    states = _states([shuf, mcmc.explode_genome(shuf), truth, shuf][:c])
    pc = RippeParams(*[torch.stack([x * (1.0 + 0.01 * k) for k in range(c)]) for x in params])
    l0 = r.chains_anchor_fn()(states, pc)
    orders = torch.as_tensor(np.stack([np.random.default_rng(k).permutation(200)[:24]
                                       for k in range(c)]))
    ladder = torch.as_tensor(temperature_ladder(c, t_max=4.0))
    cyc = sharding.make_sharded_delta_cycle(sharding.make_mesh(world, 1), table, r.nb, 4, 64, sobs=sobs, band_w=r.w,
                                            per_chain_params=True)
    got = cyc(states, torch.Generator().manual_seed(5), pc, orders, l0, ladder)
    one = delta.make_delta_em_cycle(table, None, r.nb, 4, 64, sobs=sobs, anchor_fn=False,
                                    band_w=r.w)
    want = one(states, torch.Generator().manual_seed(5), pc, orders, l0, ladder)
    return {"equal": _equal(got[0], want[0]) and _equal(got[1], want[1]),
            "moved": not torch.equal(got[0].id_c, states.id_c),
            "l_ts": got[1].tolist()}


def check_tempered(world):
    from graal_tpu_torch.core import mcmc
    from graal_tpu_torch.parallel import sharding, tempering

    state, table, params, obs, nb = _dense_problem()
    c = world
    states = _states([mcmc.explode_genome(state)] * c)
    l0 = mcmc._default_scorer(table, obs, torch.float32)(states, params)
    orders = torch.stack([torch.randperm(state.n_frags, generator=torch.Generator()
                                         .manual_seed(k))[:12] for k in range(c)])
    ladder = tempering.temperature_ladder(c, t_max=4.0)
    got = tempering.make_tempered_cycle(table, obs, nb, 3, mesh=sharding.make_mesh(c, 1))(
        states, torch.Generator().manual_seed(2), params, orders, l0, ladder)
    want = tempering.make_tempered_cycle(table, obs, nb, 3)(
        states, torch.Generator().manual_seed(2), params, orders, l0, ladder)
    return {"equal": _equal(got, want), "l_ts": got[1].tolist()}


def check_anchor(world):
    from graal_tpu_torch.core import mcmc, sparse
    from graal_tpu_torch.core.model import RippeParams
    from graal_tpu_torch.parallel import sharding
    from graal_tpu_torch.utils.synthetic_sparse import shuffle_genome

    truth, shuf, table, params, sobs = _scale_problem()
    w = sparse.band_width(table.len_kb, float(params.d_max))
    states = _states([truth, shuffle_genome(truth, 5, seed=32),
                      shuffle_genome(truth, 9, seed=33), mcmc.explode_genome(truth)])
    pc = RippeParams(*[torch.stack([x * (1.0 + 0.01 * k) for k in range(4)]) for x in params])
    n_chains = 2 if world % 2 == 0 else 1
    mesh = sharding.make_mesh(n_chains, world // n_chains)
    got = sharding.make_sharded_sparse_anchor(mesh, table, sobs, w)(states, pc)
    want = sparse.make_sparse_loglik(table, sobs, w)(states, pc)
    return {"got": got.tolist(), "want": want.tolist()}


def check_anchor_repeats(world):
    from graal_tpu_torch.core import sparse
    from graal_tpu_torch.parallel import sharding
    from graal_tpu_torch.scale import ScaleRunner
    from graal_tpu_torch.utils.synthetic_sparse import (add_scale_repeats, make_scale_genome,
                                                        scale_params, shuffle_genome,
                                                        simulate_sparse_contacts)

    params = scale_params()
    base, base_table = make_scale_genome(250, 3, seed=61)
    sobs = simulate_sparse_contacts(base, base_table, params, seed=61)
    state, table, id_d = add_scale_repeats(base, base_table, (17, 80, 140))
    runner = ScaleRunner(table, sobs, params, id_d=id_d)
    shuf = shuffle_genome(state, 8, seed=62)
    activ = shuf.activ.clone()
    activ[state.n_frags - 1] = 0
    states = _states([state, shuf, shuf._replace(activ=activ)])
    got = sharding.make_sharded_sparse_anchor(sharding.make_mesh(1, world), table, sobs,
                                              runner.w)(states, params)
    want = sparse.make_sparse_loglik(table, sobs, runner.w)(states, params)
    return {"got": got.tolist(), "want": want.tolist()}


def check_multihost(world):
    """tests/test_multihost.py's two-process likelihood: the rows split
    over the processes."""
    from graal_tpu_torch.core.likelihood import log_likelihood
    from graal_tpu_torch.parallel import sharding
    from graal_tpu_torch.utils.synthetic import default_params, make_genome, simulate_contacts

    state, table = make_genome(n_bins=36, n_contigs=4, subs_per_bin=3, seed=11)
    params = default_params(fact=4000.0)
    obs = simulate_contacts(state, table, params, seed=11)
    got = sharding.sharded_log_likelihood(sharding.make_mesh(1, world), table, obs)(state,
                                                                                    params)
    want = log_likelihood(state, table, torch.as_tensor(obs), params)
    return {"got": float(got), "want": float(want)}


CHECKS = [check_world, check_ll, check_ll_uneven, check_ll_repeats, check_em_step,
          check_delta_cycle, check_tempered, check_anchor, check_anchor_repeats,
          check_multihost]


def _child(rank: int, world: int, store: str, out_dir: str):
    """One rank of a gloo world: run every check, write its results."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    results = {}
    for fn in CHECKS:
        try:
            results[fn.__name__] = fn(world)
        except Exception:
            results[fn.__name__] = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(results, fh)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the worlds, and the tests that read them
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    """Every rank's results of a gloo world of ``request.param`` CPU
    processes (one launch, at most TIMEOUT_S seconds)."""
    n = request.param
    d = tmp_path_factory.mktemp(f"world{n}")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    code = ("import sys; from tests.test_torch_sharding import _child; "
            "_child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n), str(d / "store"),
                               str(d)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the {n}-process world did not finish in {TIMEOUT_S} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    res = [json.load(open(d / f"rank{r}.json")) for r in range(n)]
    return n, res


def results(world, name):
    """The check's results of every rank (failing on an error), equal
    across ranks."""
    n, res = world
    got = [r[name] for r in res]
    for r, g in enumerate(got):
        assert "error" not in g, f"rank {r}:\n{g['error']}"
    for g in got[1:]:
        assert {k: v for k, v in g.items() if k != "rank"} == \
            {k: v for k, v in got[0].items() if k != "rank"}
    return n, got[0]


def test_world_of_ranks(world):
    n, res = world
    assert [r["check_world"]["rank"] for r in res] == list(range(n))
    assert all(r["check_world"]["world"] == n for r in res)
    for r, rr in enumerate(res):
        assert rr["check_world"][f"{(n, 1)}"] == [r, 0]
        assert rr["check_world"][f"{(1, n)}"] == [0, r]
        assert rr["check_world"][f"{(2, n // 2)}"] == list(divmod(r, n // 2))


def test_sharded_ll_matches_single_device(world):
    _, got = results(world, "check_ll")
    np.testing.assert_allclose(got["got"], got["one"], rtol=1e-5)
    np.testing.assert_allclose(got["got"], got["dense"], rtol=1e-5)


def test_sharded_ll_uneven_rows(world):
    _, got = results(world, "check_ll_uneven")
    np.testing.assert_allclose(got["got"], got["one"], rtol=1e-5)
    np.testing.assert_allclose(got["got"], got["dense"], rtol=1e-5)


def test_sharded_likelihood_with_repeats(world):
    _, got = results(world, "check_ll_repeats")
    np.testing.assert_allclose(got["got"], got["one"], rtol=1e-5)
    np.testing.assert_allclose(got["got"], got["dense"], rtol=5e-4, atol=0.5)


def test_sharded_em_step_matches_one_process(world):
    _, got = results(world, "check_em_step")
    assert got["equal"]
    assert got["moved"] > 0
    np.testing.assert_allclose(got["score0"], got["rescored0"], rtol=1e-4)


def test_sharded_delta_cycle_matches_one_process(world):
    _, got = results(world, "check_delta_cycle")
    assert got["equal"] and got["moved"]
    assert np.all(np.isfinite(got["l_ts"]))


def test_tempered_chains_over_ranks_match_one_process(world):
    _, got = results(world, "check_tempered")
    assert got["equal"]


def test_sharded_sparse_anchor_matches_local(world):
    _, got = results(world, "check_anchor")
    np.testing.assert_allclose(got["got"], got["want"], rtol=1e-6)
    assert len(np.unique(np.round(got["want"], 2))) >= 3


def test_sharded_sparse_anchor_with_repeats(world):
    _, got = results(world, "check_anchor_repeats")
    np.testing.assert_allclose(got["got"], got["want"], rtol=1e-6)


def test_multiprocess_sharded_likelihood(world):
    """In the world of two, tests/test_multihost.py's two-process run."""
    _, got = results(world, "check_multihost")
    assert abs(got["got"] - got["want"]) < max(1.0, 1e-4 * abs(got["want"]))


# ---------------------------------------------------------------------------
# a one-rank world, in this process
# ---------------------------------------------------------------------------

def test_one_rank_mesh_equals_one_process():
    from graal_tpu_torch.core import delta, sparse
    from graal_tpu_torch.parallel import sharding
    from graal_tpu_torch.scale import ScaleRunner

    assert sharding.world_size() == 1 and sharding.is_writer()
    mesh = sharding.make_mesh()
    assert mesh.shape == {"chains": 1, "rows": 1} and mesh.rows_group is None
    state, table, params, obs, _ = _dense_problem()
    got = sharding.sharded_log_likelihood(mesh, table, obs)(state, params)
    assert torch.equal(got, sharding._block_log_likelihood(state, table, torch.as_tensor(obs),
                                                           params, 0).float())
    truth, shuf, table, params, sobs = _scale_problem()
    r = ScaleRunner(table, sobs, params)
    states = _states([truth, shuf])
    assert torch.equal(sharding.make_sharded_sparse_anchor(mesh, table, sobs, r.w)(states,
                                                                                   params),
                       sparse.make_sparse_loglik(table, sobs, r.w)(states, params))
    orders = torch.stack([torch.arange(16), torch.arange(16, 32)])
    cyc = sharding.make_sharded_delta_cycle(mesh, table, r.nb, 4, 64, sobs=sobs)
    one = delta.make_delta_em_cycle(table, None, r.nb, 4, 64, sobs=sobs, anchor_fn=False)
    l0 = torch.zeros(2)
    got = cyc(states, torch.Generator().manual_seed(1), params, orders, l0, 1.0)
    want = one(states, torch.Generator().manual_seed(1), params, orders, l0, 1.0)
    assert _equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sharded_ll_matches_jax_mesh():
    """The port's sharded likelihood (one rank) and the JAX package's on
    its 8-device CPU mesh, on the same problem, at rtol 1e-5."""
    import jax

    import __graft_entry__ as graft
    from graal_tpu.parallel import make_mesh as j_make_mesh
    from graal_tpu.parallel import sharded_log_likelihood as j_sharded
    from graal_tpu_torch.parallel import sharding

    j_state, j_table, j_params, j_obs, _ = graft._problem(n_bins=36, n_contigs=4, seed=11)
    state, table, params, obs, _ = _dense_problem()
    np.testing.assert_array_equal(np.asarray(j_obs), obs)
    want = float(j_sharded(j_make_mesh(n_chains=1, n_rows=8, devices=jax.devices()[:8]),
                           j_table, j_obs)(j_state, j_params))
    got = float(sharding.sharded_log_likelihood(sharding.make_mesh(), table, obs)(state, params))
    np.testing.assert_allclose(got, want, rtol=1e-5)
