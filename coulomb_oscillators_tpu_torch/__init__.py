"""coulomb_oscillators_tpu_torch — the PyTorch + CUDA port of
``coulomb_oscillators_tpu``.

The JAX package stays the reference; every module here sits at the same
relative path as its twin and says so in its docstring.  Plain tensor code
is PyTorch; the near-field P2P pass is a hand-written CUDA kernel for
Hopper (``csrc/p2p.cu``), with its plain PyTorch version beside it.  The
package never imports ``jax``.
"""

from coulomb_oscillators_tpu_torch.config import SimConfig
from coulomb_oscillators_tpu_torch.state import ParticleState

__version__ = "0.1.0"

__all__ = ["SimConfig", "ParticleState", "__version__"]
