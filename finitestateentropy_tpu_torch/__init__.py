"""finitestateentropy_tpu_torch — the TurboRANS codec on PyTorch and CUDA.

The port of ``finitestateentropy_tpu`` to an NVIDIA Hopper GPU.  Plain
tensor code is PyTorch; every coder kernel is CUDA C++ written for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes``.  Frames are byte-identical to the JAX package's.

The package imports ``torch`` and numpy only.  It never imports ``jax`` or
the JAX package: the host modules it needs (normalization, NCount, the
numpy twin, the table packers) are its own copies, which the tests hold
equal to the originals.

Package layout (each module's counterpart has the same path in the JAX
package):
  refimpl/   hist, normalization and NCount (reference-exact host code).
  utils/     debug logging and the probaGenerator twin.
  turbo/     the TurboRANS wires (rans.py and format.py: byte; pair.py:
             pair; quad.py: quad; rans16.py: the U16 codec), the table packers
             (tables.py), the kernel wrappers (rans_kernels.py), the
             state carry-across (state.py) and the entry points (api.py).
  csrc/      the CUDA kernels.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

from .config import FSE_DEFAULT_TABLELOG, FSE_MAX_TABLELOG, FSE_MIN_TABLELOG

__version__ = "0.1.0"
