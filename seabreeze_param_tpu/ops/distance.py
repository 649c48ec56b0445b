"""Signed distance-to-coast transform.

Gather-form restructuring of ``get_dist``
(``python_wrapper/seabreezediag/sobel.f90:91-193``).

The reference is a *scatter*: every coastal point walks a (2k+1)^2
neighborhood and scatter-mins a haversine distance into each neighbor
(sobel.f90:154-190), with k = int(maxdist / dx) cells where dx is the
diagonal cell size at ~70 deg latitude (sobel.f90:129-137).  Scatter-min with
data-dependent writes does not vectorise.  Two observations make a clean
gather-form possible:

1. **Scatter/gather duality.**  The neighborhood is symmetric in index
   space, so "coastal point j scatters to xx = periodic(j+jj)" is exactly
   "target xx gathers from sources j = periodic(xx-jj)".  The latitude
   clamp in the scatter (sobel.f90:159) only ever re-delivers distances that
   the unclamped window also delivers (min dedups), so the gather window is
   simply the valid rows |di| <= k.  min is commutative and the sign depends
   only on the *target* cell's land mask (sobel.f90:178-183), so the result
   is order-independent — which also removes the benign scatter race of the
   OpenMP reference (SURVEY §5.2).

2. **Monotonicity.**  c = 2R*atan2(sqrt(a), sqrt(1-a)) + 0.5 is monotone
   increasing in the haversine parameter a for a in [0,1].  So we minimize
   *a* (one multiply-add per offset) and evaluate the transcendentals once on
   the winner, not (2k+1)^2 times.

For a fixed grid, a decomposes into per-axis tables:
   a(y, x, di, dj) = sdphi2[y, di] + po[y, di] * sdlam2[x, dj]
with sdphi2 = sin^2(dphi/2), po = cos(phi_src)*cos(phi_tgt),
sdlam2 = sin^2(dlam/2) — all host-precomputed in float32 from the concrete
coordinate vectors (works for non-uniform grids too; dlam uses the
(-180, 180] re-branching of sobel.f90:165-174, whose 360-degree jumps are
invisible to sin^2).

The implementation below is separable: pass 1 takes a masked sliding min
of the lon table along each row, pass 2 a min of sdphi2 + po * (pass-1
value) along each column — O(2k+1) sliced passes instead of O((2k+1)^2).

Final-pass quirk: any cell whose |cdist| ends above 2*maxdist is reset to
the 12000 km sentinel.  The reference applies this *inside* the scatter loop
(sobel.f90:188), which is loop-order-dependent and thread-racy; on its real
(global, periodic) workloads no in-window distance exceeds 2*maxdist so the
orders are indistinguishable, and we implement the deterministic final-pass
form (see tests/golden/reference_numpy.py::golden_get_dist).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core.grid import Grid, EARTH_RADIUS_KM, DEG2RAD_F32

BIG_PARAM = np.float32(1.0e30)
_SENTINEL = np.float32(12000.0)


def distance_tables(grid: Grid, k: int):
    """Host-side float32 tables for the decomposed haversine parameter.

    Returns (sdphi2, po, sdlam2):
      sdphi2 : (nlat, 2k+1)  sin^2((phi[y+di] - phi[y]) / 2); BIG at rows
               where y+di falls outside the grid (poisoned-invalid).
      po     : (nlat, 2k+1)  cos(phi[y+di]) * cos(phi[y]); 0 at invalid rows.
      sdlam2 : (nlon, 2k+1)  sin^2((lon_b[(x+dj) % n] - lon_b[x]) / 2).
    """
    phi = grid.phi.astype(np.float32)
    lonb = grid.lon_branched.astype(np.float32)
    nlat, nlon = grid.nlat, grid.nlon
    offs = np.arange(-k, k + 1)

    ysrc = np.arange(nlat)[:, None] + offs[None, :]
    row_valid = (ysrc >= 0) & (ysrc < nlat)
    ysrc_c = np.clip(ysrc, 0, nlat - 1)
    dphi = (phi[ysrc_c] - phi[:, None]).astype(np.float32)
    sdphi2 = np.sin(dphi / np.float32(2.0), dtype=np.float32) ** 2
    po = (np.cos(phi[ysrc_c], dtype=np.float32)
          * np.cos(phi[:, None], dtype=np.float32)).astype(np.float32)
    # In exact arithmetic po = cos*cos >= 0 on [-90, 90] deg; float32
    # rounding of the 90-deg radian makes cos(phi) ~ -4.4e-8 at exact pole
    # rows.  Clamping restores the true sign (strictly MORE accurate than
    # the f32 noise) and guarantees the pass-1 window minimum is attained
    # at Mmin alone — which halves pass 1 (no Mmax tracking; the pipeline's
    # dominant stage at 0.1 deg).  Effect is confined to distances sourced
    # at exact +-90 rows and is far inside the golden tolerances.
    po = np.maximum(po, np.float32(0.0))
    sdphi2 = np.where(row_valid, sdphi2, BIG_PARAM).astype(np.float32)
    po = np.where(row_valid, po, np.float32(0.0)).astype(np.float32)

    xsrc = (np.arange(nlon)[:, None] + offs[None, :]) % nlon
    dlam = (lonb[xsrc] - lonb[:, None]).astype(np.float32)
    sdlam2 = np.sin(dlam / np.float32(2.0), dtype=np.float32) ** 2
    return sdphi2, po, sdlam2


def pass1_extrema(cpad, sdlam2, k: int, *, unroll: bool | None = None,
                  need_max: bool = False):
    """Pass 1 of the separable min: per padded row, the masked sliding
    min (and, with ``need_max``, max) of sdlam2 over the lon window dj (see
    :func:`min_haversine_param_from_padded`).  Returns (Mmin, Mmax), each
    (h+2k, w); BIG / -BIG where the window holds no coast cell.

    ``need_max=False`` (the default — :func:`distance_tables` clamps po to
    >= 0, making Mmin alone sufficient) skips the max channel entirely and
    returns ``Mmax=None``: HALF the taps of the pipeline's dominant stage
    at 0.1 deg."""
    h2k = cpad.shape[0]
    w = cpad.shape[1] - 2 * k
    nwin = 2 * k + 1
    sdlam2 = jnp.asarray(sdlam2)
    if unroll is None:
        unroll = nwin <= 64

    def body_j(dj, mm, static=False):
        mmin, mmax = mm
        if static:
            win = cpad[:, dj:dj + w] > 0.0
            cand = sdlam2[:, dj][None, :]
        else:
            win = lax.dynamic_slice(cpad, (0, dj), (h2k, w)) > 0.0
            cand = lax.dynamic_slice(sdlam2, (0, dj), (w, 1)).T  # (1, w)
        mmin = jnp.where(win, jnp.minimum(mmin, cand), mmin)
        if need_max:
            mmax = jnp.where(win, jnp.maximum(mmax, cand), mmax)
        return (mmin, mmax)

    m0 = (jnp.full((h2k, w), BIG_PARAM, jnp.float32),
          jnp.full((h2k, w), -BIG_PARAM, jnp.float32) if need_max
          else jnp.zeros((0,), jnp.float32))
    if unroll:
        for dj in range(nwin):
            m0 = body_j(dj, m0, static=True)
    else:
        m0 = lax.fori_loop(0, nwin, body_j, m0)
    return (m0[0], m0[1]) if need_max else (m0[0], None)


def pass1_extrema_nearest(cpad, k: int, half_dlam: float):
    """Fast pass 1 for UNIFORM-lon grids: O(log k) instead of O(2k+1).

    On a uniform grid ``sdlam2[x, dj] = sin^2(|dj-k| * dlam / 2)`` is
    monotone in the offset magnitude (checked by :func:`uniform_half_dlam`
    via k*dlam <= 180 deg), so the masked window *min* of sdlam2 is
    attained at the NEAREST coast cell within +-k — a classic log-doubling
    problem: bidirectional min-plus doubling on the cell-distance field
    ``d = 0 where coast else BIG`` — ``d = min(d, d[x-s]+s, d[x+s]+s)``
    for s = 1, 2, 4, ... is exact for every distance within the
    accumulated reach (binary decomposition of the offset keeps all
    intermediate hops inside the span), and the final ``d <= k`` test
    discards beyond-window finds exactly.  (No max channel: po >= 0 by the
    :func:`distance_tables` clamp.)

    Values are then ``sin^2(d * dlam/2)`` computed directly — equal to
    the table entries up to float32 rounding of the branched-longitude
    differences (allclose, not bit-exact; the tapped
    :func:`pass1_extrema` remains the exact-parity default).  Returns
    (Mmin, None) with the same contract (BIG on empty windows).

    It trades the 2k+1 taps for ~log2(k) data-dependent doubling rounds,
    each a full-array sweep, while the tapped form fuses all taps into one
    sweep; which is faster is a question for the device's trace.  The
    tapped :func:`pass1_extrema` is the default everywhere.
    """
    h2k = cpad.shape[0]
    w2k = cpad.shape[1]
    w = w2k - 2 * k
    coast = cpad > 0.0
    big = jnp.float32(BIG_PARAM)

    # --- nearest: bidirectional min-plus doubling --------------------
    d = jnp.where(coast, jnp.float32(0.0), big)
    s, reach = 1, 0
    while reach < k:
        sf = jnp.float32(s)
        left = jnp.concatenate(
            [d[:, s:], jnp.full((h2k, s), big, jnp.float32)], axis=1)
        right = jnp.concatenate(
            [jnp.full((h2k, s), big, jnp.float32), d[:, :-s]], axis=1)
        d = jnp.minimum(d, jnp.minimum(left + sf, right + sf))
        reach += s
        s *= 2
    dnear = d

    # --- center columns, values --------------------------------------
    # (the farthest/Mmax channel is gone: distance_tables clamps po >= 0,
    # so the window minimum is always attained at the nearest coast cell)
    ctr = slice(k, k + w)
    dnear_c = dnear[:, ctr]
    found = dnear_c <= jnp.float32(k)
    half = jnp.float32(half_dlam)
    smin = jnp.sin(dnear_c * half)
    Mmin = jnp.where(found, smin * smin, big)
    return Mmin, None


def uniform_half_dlam(grid: Grid, k: int | None = None):
    """f32 half-spacing of a uniform GLOBAL lon axis, else None (static,
    host-side).

    The nearest/farthest pass-1 form needs ``sdlam2[x, dj]`` to depend
    only on |dj|: true for a uniform axis spanning the full circle (the
    periodic wrap shifts the angle by exactly 360 deg, invisible to
    sin^2), but FALSE on regional grids, whose index-periodic wrap jumps
    by the domain width — there the tapped table form is the only correct
    one (it is also what the reference's quirky seam produces).

    With ``k`` given, additionally require sin^2(d * dlam/2) to be
    MONOTONE over the whole +-k window, i.e. k * dlam <= 180 deg — the
    assumption :func:`pass1_extrema_nearest` rests on.  An extreme
    ``maxdist`` override on a coarse grid violates it (e.g. k > nlon/2);
    returning None there routes such configs to the exact tapped form."""
    if grid.nlon < 2:
        return None
    lon = grid.lon.astype(np.float64)
    diffs = np.diff(lon)
    step = diffs.mean()
    # f32 coordinate vectors jitter by ~eps(360) even for nominally
    # uniform axes; accept spacing uniform to ~0.1% (the induced distance
    # error is ~0.1% of a cell, far inside the science tolerances).
    if not np.allclose(diffs, step, rtol=0, atol=1e-3 * abs(step)):
        return None
    if not np.isclose(step * grid.nlon, 360.0, rtol=1e-4):
        return None      # regional domain: fake seam breaks |dj|-form
    if k is not None and k * abs(step) > 180.0:
        return None      # window wider than a half-circle: sin^2 no longer
        #                  monotone in |dj| — nearest/farthest form invalid
    return np.float32(np.float32(step) * DEG2RAD_F32 / np.float32(2.0))


def pass2_min(Mmin, Mmax, sdphi2, po, k: int, *,
              unroll: bool | None = None):
    """Pass 2 of the separable min: per target row, the min over the lat
    window di of sdphi2 + po * extremum (see
    :func:`min_haversine_param_from_padded`).  Returns amin (h, w).
    ``Mmax=None`` selects the single-extremum form (po >= 0, the
    :func:`distance_tables` guarantee)."""
    h = Mmin.shape[0] - 2 * k
    w = Mmin.shape[1]
    nwin = 2 * k + 1
    sdphi2 = jnp.asarray(sdphi2)
    po = jnp.asarray(po)
    if unroll is None:
        unroll = nwin <= 64

    def body_i(di, amin, static=False):
        if static:
            lo = Mmin[di:di + h]
            p = po[:, di:di + 1]
            s = sdphi2[:, di:di + 1]
        else:
            lo = lax.dynamic_slice(Mmin, (di, 0), (h, w))
            p = lax.dynamic_slice(po, (0, di), (h, 1))
            s = lax.dynamic_slice(sdphi2, (0, di), (h, 1))
        if Mmax is None:
            inner = p * lo
        else:
            hi = (Mmax[di:di + h] if static
                  else lax.dynamic_slice(Mmax, (di, 0), (h, w)))
            inner = jnp.minimum(p * lo, p * hi)
        cand = s + inner
        cand = jnp.where(lo > BIG_PARAM / 2, BIG_PARAM, cand)  # empty window
        return jnp.minimum(amin, cand)

    amin0 = jnp.full((h, w), BIG_PARAM, jnp.float32)
    if unroll:
        for di in range(nwin):
            amin0 = body_i(di, amin0, static=True)
        return amin0
    return lax.fori_loop(0, nwin, body_i, amin0)


def min_haversine_param_from_padded(cpad, sdphi2, po, sdlam2, k: int,
                                    *, unroll: bool | None = None,
                                    half_dlam=None):
    """Core gather-min over a k-padded coast block — separable two-pass form.

    ``cpad`` is (h+2k, w+2k): rows beyond the *global* lat edge zero-filled
    (zero = never a source; the reference's lat clamp only duplicates
    candidates the valid window already delivers), columns wrapped
    periodically (sobel.f90:163-164 — get_dist uses the clean periodic map).
    ``sdphi2``/``po`` are this block's (h, 2k+1) row-table slices, ``sdlam2``
    the (w, 2k+1) column-table slice — under shard_map they arrive pre-sliced
    by the in_specs.

    The naive form scans all (2k+1)^2 offsets.  For any fixed di the inner
    min over dj is ``po[di] * min(sdlam2 over coast cells)`` — exact
    because :func:`distance_tables` guarantees po >= 0 (po is cos*cos,
    >= 0 in exact arithmetic; the f32 pole-row rounding to ~-4e-8 is
    clamped away at table build):

        min_{di,dj: coast} sdphi2[di] + po[di] * sdlam2[x, dj]
          = min_di ( sdphi2[di] + po[di] * Mmin[y+di, x] )

    — the same winning value as the full 2-D scan, in O(2k+1) sliced
    FMA/min passes instead of O((2k+1)^2).  Row-windows with no coast cell
    are poisoned explicitly (Mmin stays BIG); beyond-lat-edge rows carry
    sdphi2 = BIG and never win.
    """
    # The taps are unrolled as static slices when the window is small (the
    # production regime: k=6 at 0.25 deg, k=15 at 0.1 deg), so XLA can fuse
    # each pass into one sweep over the field; very large k falls back to
    # fori_loop to bound compile time.  ``unroll`` pins the choice for tests
    # (both branches are goldened by tests/test_ops_golden.py so they cannot
    # silently diverge).
    # ``half_dlam`` (uniform-lon grids only, see uniform_half_dlam) opts
    # pass 1 into the O(log k) nearest form — allclose to the tapped form,
    # not bit-exact; None = exact taps.
    if half_dlam is not None:
        Mmin, Mmax = pass1_extrema_nearest(cpad, k, half_dlam)
    else:
        Mmin, Mmax = pass1_extrema(cpad, sdlam2, k, unroll=unroll)
    return pass2_min(Mmin, Mmax, sdphi2, po, k, unroll=unroll)


def pad_coast(coast, k: int):
    """Single-device pad: zero rows beyond the lat edges, periodic columns."""
    cpad = jnp.pad(coast, ((k, k), (0, 0)))
    return jnp.pad(cpad, ((0, 0), (k, k)), mode="wrap")


def min_haversine_param(coast, sdphi2, po, sdlam2, k: int):
    """Single-device wrapper: pad + core."""
    return min_haversine_param_from_padded(pad_coast(coast, k), sdphi2, po,
                                           sdlam2, k)


def finalize_distance(amin, lsm, maxdist):
    """Convert the winning haversine parameter to the signed, capped cdist.

    Sign comes from the *raw land fraction* at the target: the reference
    calls get_dist with mask = landfrac and tests ``mask > 0.0``
    (sobel.f90:179) — any nonzero land fraction counts as land.
    """
    found = amin < BIG_PARAM / 2
    a = jnp.clip(amin, 0.0, 1.0)
    c = (EARTH_RADIUS_KM * jnp.float32(2.0)
         * jnp.arctan2(jnp.sqrt(a), jnp.sqrt(jnp.float32(1.0) - a))
         + jnp.float32(0.5))
    sign = jnp.where(jnp.asarray(lsm, jnp.float32) > 0.0, 1.0, -1.0)
    cdist = jnp.where(found & (c < _SENTINEL), sign * c, _SENTINEL)
    # sobel.f90:188 — cap at 2*maxdist else sentinel (see module docstring).
    return jnp.where(jnp.abs(cdist) > jnp.float32(2.0) * jnp.float32(maxdist),
                     _SENTINEL, cdist)


def effective_radius(grid: Grid, maxdist: float, k: int | None = None) -> int:
    """The reference's k (sobel.f90:137), bounded to sane values."""
    if k is None:
        k = grid.search_radius_cells(maxdist)
    return max(0, min(k, max(grid.nlat, grid.nlon)))


def coast_distance(coast, lsm, grid: Grid, maxdist: float = 180.0,
                   *, k: int | None = None, lon_form: str = "taps"):
    """Full ``get_dist`` equivalent: signed km distance to the nearest
    coastline cell, positive over land, negative over sea, 12000 km sentinel
    beyond 2*maxdist.

    ``lon_form`` selects pass 1: ``'taps'`` (exact reference parity) or
    ``'nearest'`` (see :func:`pass1_extrema_nearest`).
    """
    k_eff = effective_radius(grid, maxdist, k)
    tables = distance_tables(grid, k_eff)
    half_dlam = None
    if lon_form == "nearest":
        half_dlam = uniform_half_dlam(grid, k_eff)
        if half_dlam is None:
            raise ValueError(
                "lon_form='nearest' needs a uniform global lon axis with "
                "k*dlam <= 180 deg (monotone sin^2 window)")
    elif lon_form != "taps":
        raise ValueError(lon_form)
    amin = min_haversine_param_from_padded(
        pad_coast(coast, k_eff), *tables, k_eff, half_dlam=half_dlam)
    return finalize_distance(amin, lsm, maxdist)
