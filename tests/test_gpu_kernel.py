"""On-card checks of the compiled correlator kernel (marker ``gpu``):
the kernel and the XLA epoch against the float64 reference at the widths
the receiver runs at.  chip_smoke.py runs the same comparisons."""

import dataclasses

import jax.numpy as jnp
import pytest

from cusdr_tpu.tracking.engine import epoch_correlators
from cusdr_tpu.tracking.reference import (CARD_CASES, PARITY_TOL,
                                          epoch_correlators_f64,
                                          parity_error, random_bank)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["xla", "kernel"])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_card_width_parity(gpu, case, path):
    signal, fs, pilot, interp, sb_start = CARD_CASES[case]
    samples, sb, ct, pt, state, params = random_bank(
        signal, fs, pilot, interp_taps=interp, sb_start=sb_start)
    params = dataclasses.replace(params, use_pallas=path == "kernel")
    ref, norms = epoch_correlators_f64(samples, sb, ct, pt, state, params)
    got = epoch_correlators(jnp.asarray(samples), jnp.int64(sb),
                            jnp.asarray(ct), jnp.asarray(pt), state,
                            params)
    assert parity_error(got, ref, norms) < PARITY_TOL


@pytest.mark.gpu
def test_card_width_acquisition_products(gpu):
    """The pinned acquisition products at card widths: the fine search at
    18 Msps and the L2C long-pilot search at the preset's 8 Msps."""
    import numpy as np

    from cusdr_tpu.acquisition import pcps
    from cusdr_tpu.acquisition.reference import (fine_inputs,
                                                 fine_powers_f64,
                                                 pilot_inputs,
                                                 pilot_phase_corr_f64)

    a = fine_inputs(18e6)
    ref, norms = fine_powers_f64(*a)
    got = np.asarray(pcps._fine_kernel(*map(jnp.asarray, a[:5]), a[5]))
    assert parity_error(got[:, None], ref[:, None], norms) < PARITY_TOL
    b = pilot_inputs(8e6)
    ref, norms = pilot_phase_corr_f64(*b)
    got = np.asarray(pcps._pilot_phase_corr(*map(jnp.asarray, b[:5]),
                                            b[5]))
    assert parity_error(got, ref, norms) < PARITY_TOL
