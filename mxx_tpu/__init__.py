"""mxx_tpu — lattice-cryptography framework in JAX/XLA.

Brand-new implementation with the capabilities of the MachinaIO/mxx reference
(Rust + OpenFHE + CUDA), redesigned array-first: DCRT polynomials are
uint32[L, n] arrays, matrices uint32[L, r, c, n], all ops pure jitted
functions, sharding via named meshes, randomness via counter-based keyed PRNG.
"""

import jax

# u64/f64 are required by the samplers (96-bit uniform reduction, Gaussian CDF
# tables). uint32 arrays remain uint32.
jax.config.update("jax_enable_x64", True)

from .ring.params import RingParams  # noqa: E402,F401

__all__ = ["RingParams"]
__version__ = "0.1.0"
