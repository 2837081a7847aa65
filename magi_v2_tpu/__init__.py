"""magi_v2_tpu — a JAX framework for MAnifold-constrained Gaussian process
Inference (MAGI; Yang, Wong & Kou, PNAS 2021) on an accelerator (NVIDIA
H100 GPU; the CPU backend runs the tests and the float64 setup).

Re-designed from scratch in jax / XLA, providing the
full capability surface of the reference implementation
(reference ``magi_v2.py``): Matern nu=2.01 GP kernel matrices and their
derivative cross-covariances, GP hyperparameter MLE with Fourier-informed
priors, theta / latent-trajectory initialization, a fused tempered
log-posterior, and a vmapped multi-chain NUTS/HMC sampler with in-warmup
step-size and mass-matrix adaptation and in-graph temperature annealing.

Key entry point: :class:`magi_v2_tpu.MAGI_v2` (API parity with the reference,
reference: magi_v2.py:20-73).
"""

from magi_v2_tpu.config import MagiConfig, enable_x64
from magi_v2_tpu.api import MAGI_v2

__version__ = "0.1.0"

__all__ = ["MAGI_v2", "MagiConfig", "enable_x64", "__version__"]
