"""repro_torch: the shared-memory atomic bottleneck model on PyTorch + CUDA.

The port of ``repro`` to an NVIDIA H100.  The host-side queueing model
(``core``, ``analysis``) is the same numpy code; the kernels the model
measures are hand-written CUDA for Hopper (``kernels/csrc``), bound with
ctypes and built with nvcc at first use.  Beside it, the LM substrate's
dense serving path (``configs``, ``models``, ``serve``, ``launch``) runs
its prefill attention in the flash-attention kernel.

Kept import-light: importing ``repro_torch`` builds and loads nothing.
"""

__version__ = "0.11.0"

__all__ = ["__version__"]
