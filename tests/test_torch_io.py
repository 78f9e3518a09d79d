"""Parity of the port's data layer (graal_tpu_torch.io, utils.dataset,
utils.checkpoint) with the JAX package, on the CPU.

- The two synthetic dataset writers give byte-identical files for one seed.
- Contact parsing: the port's native parser, its numpy plain version and
  the JAX package's parsers give equal triplets; a malformed file raises,
  and so does a build without a compiler.
- ``build_and_filter``, with and without ``ref_quirks``, in two copies of
  one dataset: every level's fragment list, contig info and COO text file
  is byte-identical, and each ``Level``'s triplets, ``genome_soa()``,
  ``sub_ranges`` and ``mean_value_trans()`` are equal. A folder built by
  one package opens in the other.
- ``export_assembly`` of one state (torch and JAX) writes identical
  ``genome.fasta``, ``info_frags.txt`` and ``assembly_stats.json``.
- Round trips of the readers and writers, and of the checkpoint.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

from graal_tpu.io import fasta as jfasta
from graal_tpu.io import formats as jformats
from graal_tpu.io import native_io as jnative
from graal_tpu.io import pyramid as jpyr
from graal_tpu.utils.dataset import write_synthetic_dataset as jwrite
from graal_tpu_torch.io import fasta as tfasta
from graal_tpu_torch.io import formats as tformats
from graal_tpu_torch.io import native_io as tnative
from graal_tpu_torch.io import pyramid as tpyr
from graal_tpu_torch.utils import checkpoint as tckpt
from graal_tpu_torch.utils.dataset import write_synthetic_dataset as twrite
from tests.test_torch_state import to_port

DATASET_FILES = ("fragments_list.txt", "info_contigs.txt",
                 "abs_fragments_contacts_weighted.txt", "genome.fa")


def same_files(a, b, names):
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tio") / "ds")
    info = twrite(d, n_bins=96, n_contigs=3, seed=4)
    return d, info


def test_dataset_writers_byte_identical(tmp_path):
    for kw in (dict(n_bins=96, n_contigs=3, seed=4),
               dict(n_bins=61, n_contigs=4, seed=9, contacts_scale=25.0)):
        dj, dt = str(tmp_path / f"j{kw['seed']}"), str(tmp_path / f"t{kw['seed']}")
        info_j, info_t = jwrite(dj, **kw), twrite(dt, **kw)
        assert {k: v for k, v in info_j.items() if k not in ("dir", "fasta")} == \
            {k: v for k, v in info_t.items() if k not in ("dir", "fasta")}
        same_files(dj, dt, DATASET_FILES)


def test_contact_parsers_agree(dataset, tmp_path):
    d, info = dataset
    pairs = os.path.join(d, "abs_fragments_contacts_weighted.txt")
    native = tnative.raw_pairs_to_coo(pairs)
    for other in (tformats.raw_pairs_to_coo(pairs), jformats.raw_pairs_to_coo(pairs),
                  jnative.raw_pairs_to_coo(pairs)):
        for a, b in zip(native, other):
            np.testing.assert_array_equal(a, b)
    assert native[2].sum() == info["n_contact_pairs"]
    coo = str(tmp_path / "coo.txt")
    tnative.raw_pairs_to_coo(pairs, coo)
    for reader in (tnative.read_coo, tformats.read_coo, jformats.read_coo, jnative.read_coo):
        for a, b in zip(native, reader(coo)):
            np.testing.assert_array_equal(a, b)


def test_native_parser_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.txt"
    bad.write_text("a\tb\tn\n1\tx\t3\n")
    with pytest.raises(ValueError):
        tnative.read_coo(str(bad))
    with pytest.raises(OSError):
        tnative.read_coo(str(tmp_path / "missing.txt"))
    # no compiler: the build raises instead of falling back to numpy
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="compiler"):
        tnative.build()


def assert_levels_equal(lt, lj):
    assert lt.n_frags == lj.n_frags
    np.testing.assert_array_equal(lt.sparse.toarray(), lj.sparse.toarray())
    st, sj = lt.genome_soa(), lj.genome_soa()
    assert st.keys() == sj.keys()
    for k in st:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert lt.mean_value_trans() == lj.mean_value_trans()
    np.testing.assert_array_equal(lt.dense_matrix(), lj.dense_matrix())


def level_files(folder, size):
    return [os.path.join(f"level_{lv}", f"{lv}_{name}") for lv in range(size)
            for name in ("fragments_list.txt", "contig_info.txt", "abs_frag_contacts.txt")]


@pytest.mark.parametrize("ref_quirks", [False, True])
def test_build_and_filter_matches_jax(dataset, tmp_path, ref_quirks):
    d, _ = dataset
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    for dst in (dj, dt):
        shutil.copytree(d, dst, ignore=shutil.ignore_patterns("pyramids"))
    size = 3
    pj = jpyr.build_and_filter(dj, size, 3, ref_quirks=ref_quirks)
    pt = tpyr.build_and_filter(dt, size, 3, ref_quirks=ref_quirks)
    same_files(pj.folder, pt.folder, level_files(pt.folder, size))
    assert not os.path.exists(os.path.join(pt.folder, "pyramid.hdf5"))
    for lv in range(size):
        assert_levels_equal(pt.get_level(lv), pj.get_level(lv))
        np.testing.assert_array_equal(pt.sub_ranges(lv), pj.sub_ranges(lv))
    # idempotent: a second build reads the files and gives the same levels
    again = tpyr.build_and_filter(dt, size, 3, ref_quirks=ref_quirks)
    for lv in range(size):
        assert_levels_equal(again.get_level(lv), pj.get_level(lv))


def test_pyramid_folders_open_in_both_packages(dataset, tmp_path):
    d, _ = dataset
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    for dst in (dj, dt):
        shutil.copytree(d, dst, ignore=shutil.ignore_patterns("pyramids"))
    built_t = tpyr.build_and_filter(dt, 3, 3)
    opened_j = jpyr.build_and_filter(dt, 3, 3)     # the JAX package on a port-built folder
    built_j = jpyr.build_and_filter(dj, 3, 3)
    opened_t = tpyr.Pyramid(built_j.folder, 3)     # the port on a JAX-built folder
    for lv in range(3):
        assert_levels_equal(built_t.get_level(lv), opened_j.get_level(lv))
        assert_levels_equal(opened_t.get_level(lv), built_j.get_level(lv))


def test_export_assembly_matches_jax(dataset, tmp_path):
    """One assembled (scrambled, partly reversed, one contig with an
    inactive fragment) state exported by both packages."""
    from graal_tpu.core import ops as jops
    from graal_tpu.core.state import GenomeState as JState

    d, _ = dataset
    pj = jpyr.build_and_filter(d, 3, 3)
    lev = pj.get_level(1)
    js = JState.from_soa(lev.genome_soa())
    js = jops.flip(js, 2)
    js = jops.pop_out(js, 5, int(np.asarray(js.id_c).max()))
    activ = np.asarray(js.activ).copy()
    activ[7] = 0
    js = js._replace(activ=activ)
    seqs = jfasta.load_fasta(os.path.join(d, "genome.fa"))
    f = lev.frags
    outs = {}
    for name, export, state in (("j", jfasta.export_assembly, js),
                                ("t", tfasta.export_assembly, to_port(js))):
        out = tmp_path / name
        out.mkdir()
        outs[name] = str(out)
        export(state, f.chrom, f.start_pos, f.end_pos, seqs, str(out / "genome.fasta"),
               str(out / "info_frags.txt"))
    same_files(outs["j"], outs["t"], ("genome.fasta", "info_frags.txt", "assembly_stats.json"))
    assert tfasta.assembly_stats([5, 3, 2]) == jfasta.assembly_stats([5, 3, 2])


def test_readers_writers_round_trip(dataset, tmp_path):
    d, _ = dataset
    frags = tformats.read_fragments_list(os.path.join(d, "fragments_list.txt"))
    for with_sub in (False, True):
        path = str(tmp_path / f"frags_{with_sub}.txt")
        tformats.write_fragments_list(path, frags, with_sub=with_sub)
        back = tformats.read_fragments_list(path)
        for field in ("rel_id", "start_pos", "end_pos", "size", "gc_content", "accu_frag",
                      "init_frag_start", "init_frag_end", "sub_frag_start", "sub_frag_end"):
            np.testing.assert_array_equal(getattr(back, field), getattr(frags, field))
        assert back.chrom == frags.chrom
    info = tformats.read_contig_info(os.path.join(d, "info_contigs.txt"))
    path = str(tmp_path / "contigs.txt")
    tformats.write_contig_info(path, *info)
    for a, b in zip(tformats.read_contig_info(path), info):
        np.testing.assert_array_equal(a, b)
    seqs = tfasta.load_fasta(os.path.join(d, "genome.fa"))
    path = str(tmp_path / "g.fa")
    tfasta.write_fasta(path, seqs, line_len=50)
    assert tfasta.load_fasta(path) == seqs
    assert tfasta.reverse_complement("ACGTtg") == jfasta.reverse_complement("ACGTtg")


def test_checkpoint_round_trip(tmp_path):
    from graal_tpu_torch.core.model import RippeParams
    from tests.conftest import make_random_state

    state = to_port(make_random_state(np.random.default_rng(3), 20, 4))
    params = RippeParams.create(kuhn=1.1, lm=9.0, slope=-1.4, d=3.0, fact=700.0,
                                d_max=250.0, v_inter=0.2)
    gen = torch.Generator().manual_seed(5)
    torch.rand(7, generator=gen)
    metrics = {"likelihood": [-1.5, float("-inf"), 2.0 ** -30], "n_contigs": [4, 3],
               "success": [True, False], "tiers": [[64, 128], [64]], "dist": []}
    path = str(tmp_path / "ck.npz")
    tckpt.save_checkpoint(path, state, params, 3, gen,
                          extra={"l_t": np.float32(-12.25), **tckpt.metrics_extra(metrics)})
    s2, p2, cycle, gen_state, extra = tckpt.load_checkpoint(path)
    assert all(torch.equal(a, b) and a.dtype == torch.int32 for a, b in zip(s2, state))
    assert p2.astuple_np() == params.astuple_np() and cycle == 3
    g2 = torch.Generator().set_state(gen_state)
    assert torch.equal(torch.rand(5, generator=g2), torch.rand(5, generator=gen))
    assert tckpt.metrics_from_extra(extra) == metrics
    # every series is stored as numbers, not as text
    assert all(extra[k].dtype.kind in "bif" for k in extra if k.startswith("m"))
    assert extra["l_t"].dtype == np.float32 and float(extra["l_t"]) == -12.25
