"""Golden numeric oracles: literal-constant pins for the geodesy/orbit
core and a first-principles oracle for one correlator epoch.

The literals were computed once from independent transcriptions of the
published formulas (NOT the package code) and cross-checked against the
package to sub-micrometer agreement:

* Kepler: IS-GPS-200 Table 20-IV transcribed directly in numpy f64,
  including the reference's clock-corrected evaluation time
  (GPS/GPS_L1CA/include/satpos.m:50-60) — agreed with the package to
  2e-6 m before pinning.
* cart2utm: Borre's König-Weise/Andersson-Poder algorithm
  (Common/cart2utm.m); pinned as regression literals with structural
  checks (central-meridian symmetry, geodetic round trip).
* Correlator epoch: the six sums of tracking.m:295-300 evaluated by a
  direct numpy double-precision loop over the definition.
"""

import numpy as np
import pytest

from cusdr_tpu.geodesy.transforms import (cart2geo, cart2utm, geo2cart,
                                          find_utm_zone)
from cusdr_tpu.orbits.kepler import sat_pos_kepler
from cusdr_tpu.orbits.glonass import sat_pos_glonass

KEPLER_EPH = dict(t_oe=345600.0, sqrtA=5153.79, e=0.0096785, M_0=1.19731,
                  omega=0.97187, omega_0=2.46209, i_0=0.94878,
                  deltan=4.2487e-09, iDot=-4.893e-10,
                  omegaDot=-8.0834e-09,
                  C_uc=-6.0333e-06, C_us=5.1148e-06, C_rc=255.34375,
                  C_rs=-115.40625, C_ic=-9.8720e-08, C_is=1.3225e-07,
                  a_f0=-4.69238e-04, a_f1=-3.18323e-12, a_f2=0.0,
                  t_oc=345600.0, T_GD=5.122e-09)


def _kepler_independent(t, eph):
    """IS-GPS-200 Table 20-IV, transcribed directly (no package code)."""
    GM = 3.986005e14
    OMEGA_E = 7.2921151467e-5
    F = -4.442807633e-10
    dtc = t - eph["t_oc"]
    clk0 = (eph["a_f2"] * dtc + eph["a_f1"]) * dtc + eph["a_f0"] \
        - eph["T_GD"]
    time = t - clk0
    A = eph["sqrtA"] ** 2
    tk = time - eph["t_oe"]
    n = np.sqrt(GM / A ** 3) + eph["deltan"]
    M = eph["M_0"] + n * tk
    E = M
    for _ in range(30):
        E = M + eph["e"] * np.sin(E)
    nu = np.arctan2(np.sqrt(1 - eph["e"] ** 2) * np.sin(E),
                    np.cos(E) - eph["e"])
    phi = nu + eph["omega"]
    u = phi + eph["C_us"] * np.sin(2 * phi) + eph["C_uc"] * np.cos(2 * phi)
    r = A * (1 - eph["e"] * np.cos(E)) \
        + eph["C_rs"] * np.sin(2 * phi) + eph["C_rc"] * np.cos(2 * phi)
    i = eph["i_0"] + eph["C_is"] * np.sin(2 * phi) \
        + eph["C_ic"] * np.cos(2 * phi) + eph["iDot"] * tk
    Om = eph["omega_0"] + (eph["omegaDot"] - OMEGA_E) * tk \
        - OMEGA_E * eph["t_oe"]
    xp, yp = r * np.cos(u), r * np.sin(u)
    pos = np.asarray([xp * np.cos(Om) - yp * np.cos(i) * np.sin(Om),
                      xp * np.sin(Om) + yp * np.cos(i) * np.cos(Om),
                      yp * np.sin(i)])
    clk = clk0 + F * eph["e"] * eph["sqrtA"] * np.sin(E)
    return pos, clk


def test_kepler_literal_oracle():
    t = 345600.0 + 451.0
    pos, clk = sat_pos_kepler(t, KEPLER_EPH)
    pos = np.asarray(pos, np.float64)
    golden = np.asarray([3433278.637923, -20267935.670039,
                         16701276.335160])
    assert np.abs(pos - golden).max() < 1e-4, pos - golden
    assert clk == pytest.approx(-4.692657390646215e-04, abs=1e-15)
    # cross-check the literal against the in-test independent
    # transcription (guards the literal itself)
    ipos, iclk = _kepler_independent(t, KEPLER_EPH)
    assert np.abs(ipos - golden).max() < 1e-4
    assert iclk == pytest.approx(clk, abs=1e-15)


def test_glonass_rk4_literal_oracle():
    """Regression literal for the rotating-frame RK4+J2 integrator
    (GLO/GLO_GL1/include/satpos.m:106-145 semantics), 271 s from t_b."""
    geph = dict(t_b=40500.0, x=11234.567, y=-18456.789, z=12345.678,
                vx=1.234567, vy=2.345678, vz=-1.876543,
                ax=1e-9, ay=-2e-9, az=3e-9,
                tau_n=6.5e-5, gamma=4.66e-10, dtau=0.0)
    pos, clk = sat_pos_glonass(40500.0 + 271.0, geph, tau_c=1.2e-7)
    pos = np.asarray(pos, np.float64)
    golden = np.asarray([11572979.089097, -17813603.093652,
                         11825299.559374])
    assert np.abs(pos - golden).max() < 1e-3, pos - golden
    assert clk == pytest.approx(-6.4993714e-05, abs=1e-12)
    # sanity: the integrated point stays on a GLONASS-like radius and
    # moved ~|v|*dt from the broadcast state
    r0 = np.asarray([11234.567, -18456.789, 12345.678]) * 1e3
    assert 0.9e3 < np.linalg.norm(pos - r0) / 271.0 < 4.5e3


def test_cart2utm_literal_oracles():
    cases = [
        # (X, Y, Z) -> (zone, E, N, U)   [Aalborg-ish; Boulder CO]
        ((3427882.5, 603552.1, 5326784.9),
         (32, 559942.0946, 6319661.1214, -42.9044)),
        ((-1288398.5, -4721696.9, 4078625.3),
         (13, 477647.2856, 4427575.7412, 1419.0581)),
    ]
    for (X, Y, Z), (zone, Eg, Ng, Ug) in cases:
        lat, lon, h = cart2geo(X, Y, Z, 5)
        assert find_utm_zone(lat, lon) == zone
        E, N, U = cart2utm(X, Y, Z, zone)
        assert E == pytest.approx(Eg, abs=2e-4)
        assert N == pytest.approx(Ng, abs=2e-4)
        assert U == pytest.approx(Ug, abs=2e-4)
        # round trip through the independent geodetic path
        X2, Y2, Z2 = geo2cart(lat, lon, h, 5)
        assert np.hypot(np.hypot(X2 - X, Y2 - Y), Z2 - Z) < 1e-3


def test_correlator_epoch_first_principles():
    """One fused-correlator epoch (the GPU kernel, interpreted) vs a
    direct double-precision loop over the definition (tracking.m:280-
    300): carrier wipe-off at remc + inc*n cycles, linear replica
    interpolation at alpha, taps at 0/k/2k, valid-sample mask, window
    offsets into the record and the tables."""
    import jax.numpy as jnp
    from cusdr_tpu.ops.correlator import correlate_bank, geometry

    C, blk, k = 5, 1500, 2
    n_rec, n_tab = 6000, blk + 2 * k + 1 + 300
    rng = np.random.default_rng(11)
    si = rng.integers(-16, 16, n_rec).astype(np.int8)
    sq = rng.integers(-16, 16, n_rec).astype(np.int8)
    wt = rng.integers(-1, 2, (C, n_tab)).astype(np.int8)
    off = rng.integers(0, n_rec - blk, C)
    tstart = rng.integers(0, n_tab - blk - 2 * k - 1, C)
    alpha = rng.random(C).astype(np.float32)
    remc = rng.random(C)
    inc = rng.random(C) * 0.02
    bsz = rng.integers(blk - 300, blk + 1, C)

    pad = geometry(blk, C)[2]
    zp = lambda x: jnp.pad(jnp.asarray(x), [(0, 0)] * (x.ndim - 1)
                           + [(0, pad)])
    out = np.asarray(correlate_bank(
        zp(si), zp(sq), zp(wt), None, jnp.asarray(off),
        jnp.asarray(tstart), jnp.asarray(tstart), jnp.asarray(alpha),
        jnp.asarray(alpha), jnp.asarray(bsz), jnp.asarray(remc),
        jnp.asarray(inc), blk=blk, k=k, interpret=True))
    assert out.shape == (C, 6)

    for c in range(C):
        n = np.arange(bsz[c])
        ph = 2 * np.pi * (remc[c] + inc[c] * n)
        s = si[off[c] + n] + 1j * sq[off[c] + n].astype(np.float64)
        bb = s * np.exp(-1j * ph)
        w = wt[c, tstart[c]:].astype(np.float64)
        for tap, d in enumerate((0, k, 2 * k)):
            repl = w[n + d] + float(alpha[c]) * (w[n + d + 1] - w[n + d])
            z = (repl * bb).sum()
            assert out[c, 2 * tap] == pytest.approx(
                z.real, abs=1e-2 + abs(z.real) * 1e-5)
            assert out[c, 2 * tap + 1] == pytest.approx(
                z.imag, abs=1e-2 + abs(z.imag) * 1e-5)
