"""Build and load the port's CUDA kernels.

Each kernel source ``graal_tpu_torch/csrc/<name>.cu`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
``build/graal_tpu_torch/lib<name>-<sha16>.so`` under the checkout, and
loaded with ``ctypes``. The file name is keyed by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, and written by atomic
rename; the compiler's report (registers, spills) is kept beside it as
``.log``. Nothing is built at import: :func:`load` builds at first use, and
:func:`build` compiles several libraries at once, one ``nvcc`` process
each, all started together. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "graal_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("ll_dense", "ll_mini", "obsgrid", "ll_repeat", "candidates", "step", "mtm",
           "repeat_corr", "rows", "vectors", "scan_io", "delta_inputs")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                           "cannot build the CUDA kernels")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is (or will be) built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=KERNELS) -> dict:
    """Compile the libraries of ``names`` that are not built yet, all
    ``nvcc`` processes at once. Returns {name: seconds} for those built."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        so = library_path(name)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), so, tmp)
    seconds, failed = {}, []
    for name, (proc, so, tmp) in procs.items():
        out, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        so.with_suffix(".log").write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


_OPTED_IN = {}


def opted_in(name: str, init, dev) -> int:
    """The dynamic shared memory a launch of library ``name``'s kernels may
    ask on ``dev``. ``init`` (the library's C function) opts its kernels in
    to the device's largest and returns the bytes, or -cudaError_t; it runs
    once a device, on the library's first call there, which must not be
    captured (a capture's first step runs eagerly, ``core.graphs``)."""
    import torch

    key = (name, dev.type, dev.index)
    if key not in _OPTED_IN:
        card = dev.type == "cuda"
        if card and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}'s first call on a device is in a capture: run the step "
                               "eagerly before capturing it")
        with torch.cuda.device(dev) if card else contextlib.nullcontext():
            got = init()
        if got < 0:
            raise RuntimeError(f"{name}: opting in to shared memory failed: cudaError {-got}")
        _OPTED_IN[key] = got
    return _OPTED_IN[key]
