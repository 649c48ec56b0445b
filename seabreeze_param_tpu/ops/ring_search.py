"""Expanding-ring thermal-heating-contrast search.

The reference's hottest data-dependent construct
(``seabreeze_diag_python.f90:187-221``): per grid point, grow a square window
radius nn = 1, 2, ... until it contains both a "coastal land" point
(cdist >= 0) and a "coastal sea" point (cdist < 0), then take

    n_thc = mul * (mean(t0 over land points) - mean(t0 over sea points))

with mul = +1 on land targets, -1 on sea targets, window indexing through
the clamped-lat / quirky-lon maps (seabreeze_diag_python.f90:201-202).

A data-dependent ``while`` per point does not vectorise.  The form used
here:

1. The required radius is *bounded*: the search only runs where
   |cdist| <= maxdist, i.e. within k cells of a coastline cell, and every
   coastline cell's immediate neighborhood carries both cdist signs — so
   nn <= k + 2 always suffices (SURVEY §7 hard part 2).  NN is a static
   Python int at trace time.

2. For each nn, the four window sums (sum/count of t0 over each class) are
   maintained *incrementally*: window(nn) = window(nn-1) + two full-width
   rows (via a horizontal running sum) + two partial-height columns (via a
   vertical running sum), all O(N) sliced adds per nn — no global cumsum
   (whose float32 catastrophic cancellation at 300 K magnitudes would wreck
   the 0.75 K threshold), no (2nn+1)^2 rescan.

3. "First nn that satisfies the predicate" becomes a found-mask select —
   the vectorized equivalent of breaking out of the while loop.

Reference quirk, preserved: the land/sea classification inside this search
is ``cdist >= 0`` on the *final* cdist field — so far-from-coast ocean cells
hold the +12000 sentinel and classify as LAND (seabreeze_diag_python.f90:204).
"""
from __future__ import annotations

import jax.numpy as jnp

from .indexing import pad2d


def required_ring_radius_host(cdist, maxdist, *, exact_lon: bool = True,
                              cap: int | None = None) -> int:
    """Host-side exact bound for the expanding-ring radius.

    For every cell with |cdist| <= maxdist (the only ones searched,
    seabreeze_diag_python.f90:171), find the smallest nn whose window
    contains both cdist classes, and return the maximum over cells.  On
    physical global grids this is <= k+2; on regional grids the reference's
    index-periodic wrap can manufacture coastlines whose "far side" carries
    the +12000 sentinel (land class), pushing the required radius up — this
    helper measures it exactly so the static bound stays tight.

    NumPy + a chessboard distance transform — linear time, negligible next
    to one device step.  (The ring window of radius nn is exactly the
    Chebyshev ball, so required nn = max over classes of the Chebyshev
    distance to the nearest cell of that class.)  Uses scipy's cdt when
    available, else a pure-NumPy dilation sweep (scipy is not a hard
    dependency of this framework).
    """
    import numpy as _np
    try:
        from scipy.ndimage import distance_transform_cdt
    except ImportError:
        distance_transform_cdt = None
    from .indexing import (lat_index_clamped, lon_index_quirky,
                           lon_index_periodic, pad_indices)

    cdist = _np.asarray(cdist)
    nlat, nlon = cdist.shape
    if cap is None:
        cap = max(nlat, nlon)
    land = cdist >= 0.0
    target = _np.abs(cdist) <= _np.float32(maxdist)
    if not target.any():
        return 1
    rows = pad_indices(nlat, cap, lat_index_clamped)
    cols = pad_indices(nlon, cap,
                       lon_index_quirky if exact_lon else lon_index_periodic)
    Lp = land[rows][:, cols]

    def _cheb_dist(zero_set):
        """Chessboard distance to the nearest True cell of ``zero_set``."""
        if distance_transform_cdt is not None:
            return distance_transform_cdt(~zero_set, metric="chessboard")
        # NumPy fallback: 3x3 dilation sweeps; each round grows the
        # reached set by Chebyshev radius 1.  Bounded by cap rounds.
        reached = zero_set.copy()
        dist = _np.where(reached, 0, _np.iinfo(_np.int32).max)
        for r in range(1, int(cap) + 1):
            if reached.all():
                break
            grown = reached.copy()
            grown[1:, :] |= reached[:-1, :]
            grown[:-1, :] |= reached[1:, :]
            grown[:, 1:] |= reached[:, :-1]
            grown[:, :-1] |= reached[:, 1:]
            grown[1:, 1:] |= reached[:-1, :-1]
            grown[1:, :-1] |= reached[:-1, 1:]
            grown[:-1, 1:] |= reached[1:, :-1]
            grown[:-1, :-1] |= reached[1:, 1:]
            newly = grown & ~reached
            dist[newly] = r
            reached = grown
        return dist

    # Chebyshev distance to the nearest land / sea cell (cells of the class
    # itself get 0); clip into the padded frame's trust region.
    r_land = _cheb_dist(Lp)
    r_sea = _cheb_dist(~Lp)
    ctr = (slice(cap, cap + nlat), slice(cap, cap + nlon))
    need = _np.maximum(_np.maximum(r_land[ctr], r_sea[ctr]), 1)
    return int(min(cap, need[target].max()))



def ring_quantities(t0, cdist):
    """The three window summands: t0*land, land, t0*sea, stacked (3,h,w).

    land = (cdist >= 0) on the final cdist field — sentinel cells included
    (the reference quirk, see module docstring).  Only three channels are
    needed: every window cell (the boundary-resolved pads deliver genuine
    grid values, so land + sea = 1 everywhere) makes the sea *count* exactly
    (2nn+1)^2 - n_land — both integers below 2^24, so the float32
    subtraction is exact.  t0*sea is the exact elementwise complement
    t0 - t0*land (t0*land is t0 or 0 per cell), summed per class like the
    reference, so the temperature sums keep their per-class rounding."""
    t0 = jnp.asarray(t0, jnp.float32)
    land = (jnp.asarray(cdist, jnp.float32) >= 0.0).astype(jnp.float32)
    tl = t0 * land
    return jnp.stack([tl, land, t0 - tl])


def ring_thc_from_padded(P, mul, nn_max: int, *, coastal=None):
    """Core incremental-box-sum search on an NN-padded quantity stack.

    P   : (3, h+2NN, w+2NN) — padded :func:`ring_quantities` stack (pad from
          the exact boundary maps single-device, or a halo exchange sharded).
    mul : (h, w) — +1 land targets / -1 sea targets.
    coastal : optional (h, w) bool — the |cdist| <= maxdist cells (the only
          ones the reference searches, seabreeze_diag_python.f90:171).  When
          given, non-coastal outputs are zeroed — the reference's value there
          (its thc never exists off the coastal band).
    """
    NN = int(nn_max)
    nlat = P.shape[1] - 2 * NN
    nlon = P.shape[2] - 2 * NN

    # Running sums (order 0 to start):
    W = P[:, NN:NN + nlat, NN:NN + nlon]          # window sums, order 0
    Hp = P[:, :, NN:NN + nlon]                    # horizontal sums, all rows
    Vc = P[:, NN:NN + nlat, :]                    # vertical sums, all cols

    found = jnp.zeros((nlat, nlon), bool)
    # Latched per-class sums at each cell's first-found radius.  Dividing
    # once at the end on the latched operands is bit-identical to dividing
    # inside the loop (same operands), and drops 2*NN full-field divisions
    # to 2 — division is the most expensive elementwise op.
    Tl = jnp.zeros((nlat, nlon), jnp.float32)
    Nl = jnp.ones((nlat, nlon), jnp.float32)
    Ts = jnp.zeros((nlat, nlon), jnp.float32)
    Ns = jnp.ones((nlat, nlon), jnp.float32)

    for nn in range(1, NN + 1):
        # widen the horizontal running sum to order nn
        Hp = Hp + P[:, :, NN - nn:NN - nn + nlon] + P[:, :, NN + nn:NN + nn + nlon]
        top = Hp[:, NN - nn:NN - nn + nlat, :]
        bot = Hp[:, NN + nn:NN + nn + nlat, :]
        # vertical running sum is at order nn-1 (excludes the new rows)
        left = Vc[:, :, NN - nn:NN - nn + nlon]
        right = Vc[:, :, NN + nn:NN + nn + nlon]
        W = W + top + bot + left + right
        # then widen the vertical running sum for the next iteration
        Vc = Vc + P[:, NN - nn:NN - nn + nlat, :] + P[:, NN + nn:NN + nn + nlat, :]

        t_l, n_l, t_s = W[0], W[1], W[2]
        n_s = jnp.float32((2 * nn + 1) ** 2) - n_l    # exact (see above)
        ok = (n_l > 0.0) & (n_s > 0.0)
        newly = ok & (~found)
        last = newly | (~found & (nn == NN))   # never-found: NN-window value
        Tl = jnp.where(last, t_l, Tl)
        Nl = jnp.where(last, jnp.maximum(n_l, 1.0), Nl)
        Ts = jnp.where(last, t_s, Ts)
        Ns = jnp.where(last, jnp.maximum(n_s, 1.0), Ns)
        found = found | ok

    n_thc = mul * (Tl / Nl - Ts / Ns)
    if coastal is not None:
        n_thc = jnp.where(coastal, n_thc, jnp.float32(0.0))
    return n_thc, found


def ring_thc(t0, cdist, nn_max: int, *, exact_lon: bool = True,
             maxdist: float | None = None):
    """Vectorized expanding-ring THC.

    Parameters
    ----------
    t0 : (nlat, nlon) f32 — sea-level temperature field.
    cdist : (nlat, nlon) f32 — signed coast distance (with sentinels).
    nn_max : static int — ring radius bound (k + 2 + margin).
    maxdist : optional km — when given, restrict outputs to the coastal band
        |cdist| <= maxdist (zero elsewhere), like the reference's point loop.

    Returns
    -------
    n_thc : (nlat, nlon) f32 — thermal heating contrast; where the predicate
        never fired within nn_max (cannot happen for |cdist| <= maxdist) the
        nn_max-window value with guarded divisions is returned.
    found : (nlat, nlon) bool — diagnostic: predicate fired within nn_max.
    """
    NN = int(nn_max)
    cdist = jnp.asarray(cdist, jnp.float32)
    quant = ring_quantities(t0, cdist)                  # (3, H, W)
    P = pad2d(quant, NN, NN, exact_lon=exact_lon)       # (3, H+2NN, W+2NN)
    mul = jnp.where(cdist >= 0.0, jnp.float32(1.0), jnp.float32(-1.0))
    coastal = None if maxdist is None else (
        jnp.abs(cdist) <= jnp.float32(maxdist))
    return ring_thc_from_padded(P, mul, NN, coastal=coastal)
