"""graal_tpu_torch — the Hi-C genome reassembly engine on PyTorch and CUDA.

The PyTorch counterpart of ``graal_tpu`` (which stays the JAX reference):
the same modules under the same names, with the dense candidate scorer as
a hand-written CUDA kernel for Hopper (``ops/likelihood_cuda.py``,
``csrc/ll_dense.cu``). This package imports torch, numpy and scipy only.
"""

from graal_tpu_torch.core.model import RippeParams
from graal_tpu_torch.core.state import GenomeState

__all__ = ["GenomeState", "RippeParams"]
