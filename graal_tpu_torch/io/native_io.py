"""ctypes bindings for the native contact-pair parser (``csrc/fastio.cpp``).

Counterpart of ``graal_tpu.io.native_io``. The library is compiled with the
host's C++ compiler at first use into ``build/graal_tpu_torch/`` under the
checkout, as ``ops/build.py`` builds the kernels: the file name is keyed
by a hash of the source and the flags and written by atomic rename.
Nothing is built at import. A missing compiler or a failed build raises
``RuntimeError``, a malformed file ``ValueError``: there is no quiet
fallback. The numpy functions of :mod:`graal_tpu_torch.io.formats` are the
plain version the tests hold this parser to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from graal_tpu_torch.io import formats
from graal_tpu_torch.ops.build import BUILD_DIR, CSRC

SRC = CSRC / "fastio.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


class _CooResult(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.POINTER(ctypes.c_int64)),
        ("cols", ctypes.POINTER(ctypes.c_int64)),
        ("counts", ctypes.POINTER(ctypes.c_int64)),
        ("n", ctypes.c_int64),
        ("total", ctypes.c_int64),
        ("max_id", ctypes.c_int64),
    ]


def library_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfastio-{tag}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ / c++) on PATH: cannot build "
                           "the native contact-pair parser")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"building {SRC.name} failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded parser library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    lib.parse_pairs.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(_CooResult)]
    lib.parse_pairs.restype = ctypes.c_int
    lib.free_coo.argtypes = [ctypes.POINTER(_CooResult)]
    lib.free_coo.restype = None
    return lib


def parse(path: str, one_based: bool, weighted: bool):
    """(rows, cols, counts) int64 of the pair file ``path``: ids shifted to
    0-based when ``one_based``, a third count column when ``weighted``,
    pairs ordered a <= b, duplicates summed, sorted by (a, b)."""
    lib = load()
    res = _CooResult()
    rc = lib.parse_pairs(os.fsencode(path), int(one_based), int(weighted),
                         ctypes.byref(res))
    if rc == -1:
        raise OSError(f"cannot read contact file {path!r}")
    if rc != 0:
        raise ValueError(f"malformed contact file {path!r} (native parser rc={rc})")
    try:
        n = res.n
        if n == 0:
            return (np.zeros(0, np.int64),) * 3
        return tuple(np.ctypeslib.as_array(p, shape=(n,)).copy()
                     for p in (res.rows, res.cols, res.counts))
    finally:
        lib.free_coo(ctypes.byref(res))


def raw_pairs_to_coo(pairs_path: str, coo_path: str | None = None):
    """Native :func:`formats.raw_pairs_to_coo` (1-based raw pair list)."""
    rows, cols, counts = parse(pairs_path, one_based=True, weighted=False)
    if coo_path is not None:
        formats.write_coo(coo_path, rows, cols, counts)
    return rows, cols, counts


def read_coo(path: str):
    """Native :func:`formats.read_coo` (0-based weighted COO file)."""
    return parse(path, one_based=False, weighted=True)
