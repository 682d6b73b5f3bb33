"""repro_torch: the shared-memory atomic bottleneck model on PyTorch + CUDA.

The port of ``repro`` to an NVIDIA H100.  The host-side queueing model
(``core``, ``analysis``) is the same numpy code; the kernels the model
measures are hand-written CUDA for Hopper (``kernels/csrc``), bound with
ctypes and built with nvcc at first use.

Kept import-light: importing ``repro_torch`` builds and loads nothing.
"""

__version__ = "0.11.0"

__all__ = ["__version__"]
