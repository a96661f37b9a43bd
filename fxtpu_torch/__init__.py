"""fxtpu_torch — the fxtpu FX correlator in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A package beside the JAX package ``fxtpu``, which stays the reference the
port is tested against.  It imports ``torch`` and never ``jax``.  Run it
with ``python -m fxtpu_torch`` (see ``fxtpu_torch.cli``).
"""

from fxtpu_torch.config import MODES, STATES, CorrelatorConfig

__version__ = "0.1.0"

__all__ = ["CorrelatorConfig", "STATES", "MODES", "__version__"]
