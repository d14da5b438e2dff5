"""cusdr_tpu — multi-constellation GNSS software receiver for JAX
accelerators (the GPU path is the measured one).

A ground-up JAX/XLA/Pallas re-design with the capabilities of the
CU-SDR-Collection MATLAB receivers (GPS L1CA/L2C/L5C, Galileo E1C/E5a/E5b,
GLONASS L1/L2, BeiDou B1C/B1I/B2a/B3I): FFT-based PCPS acquisition,
vectorized channel-bank DLL/PLL tracking, navigation-message decoding and
least-squares PVT.
"""

__version__ = "0.1.0"

import jax as _jax

# Tracking-loop phase accumulators carry float64 scalars (survey §7 hard
# part 2: fractional-phase arithmetic); per-sample arrays stay float32.
_jax.config.update("jax_enable_x64", True)

from .config import ReceiverConfig, get_config, PRESETS  # noqa: F401
