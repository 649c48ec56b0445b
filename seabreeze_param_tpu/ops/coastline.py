"""Coastline extraction: land+ice mask and the binary Sobel edge filter.

Vectorised re-design of ``get_edges`` (reference:
``python_wrapper/seabreezediag/sobel.f90:19-89``).  The Fortran is a per-point
3x3 loop with boundary index arithmetic; here the whole operator is a handful
of shifted-slice adds over a boundary-resolved padded field — XLA fuses it
into a single elementwise pass, and under ``shard_map`` the pad is produced by a
1-wide halo exchange instead of local gathers (``parallel.halo``).

Semantics (python-wrapper variant, the authoritative one):
  * ``mask = lsm + ci`` then binarized at ``> 0.4`` (sobel.f90:51, 69-73).
  * Sobel x/y gradients with the (1,2,1) smoothing taps (sobel.f90:54-75).
  * Output is binary: coast = 1 wherever the gradient magnitude is nonzero
    (sobel.f90:78-84).  Since p = sqrt(px^2+py^2) == 0 iff px == py == 0 and
    px, py are small-integer-valued, the sqrt never needs computing.
  * Boundaries: lat clamped, lon through the quirky ``max(1, modulo(...))``
    map (sobel.f90:67-68) — see ``ops.indexing``.
"""
from __future__ import annotations

import jax.numpy as jnp

from .indexing import pad2d


def make_mask(lsm, ci=None):
    """Combined land/sea-ice mask, binarized.

    Reference: ``mask = lsm + ci`` (sobel.f90:51) followed by the ``> 0.4``
    threshold applied inside the stencil loop (sobel.f90:69-73).  We binarize
    once up front — equivalent, and cheaper than thresholding per tap.
    """
    lsm = jnp.asarray(lsm, jnp.float32)
    m = lsm if ci is None else lsm + jnp.asarray(ci, jnp.float32)
    return (m > jnp.float32(0.4)).astype(jnp.float32)


def sobel_edges_from_padded(p):
    """Sobel-edge core on a 1-padded binary block (h+2, w+2) -> (h, w).

    Used directly by the shard_map path, whose pad comes from a halo
    exchange; the single-device wrapper below builds the pad with the exact
    reference boundary maps.
    """
    # (1,2,1) smoothing along lat, then central difference along lon -> px
    sm_lat = p[:-2, :] + 2.0 * p[1:-1, :] + p[2:, :]
    px = sm_lat[:, 2:] - sm_lat[:, :-2]
    # (1,2,1) smoothing along lon, then central difference along lat -> py
    sm_lon = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]
    py = sm_lon[2:, :] - sm_lon[:-2, :]
    return ((px != 0.0) | (py != 0.0)).astype(jnp.float32)


def sobel_edges(binary_mask, *, exact_lon: bool = True):
    """Binary coastline from a binary land mask (single-device form)."""
    return sobel_edges_from_padded(
        pad2d(binary_mask, 1, 1, exact_lon=exact_lon))


def get_edges(lsm, ci=None, *, exact_lon: bool = True):
    """Full ``get_edges`` equivalent: mask + Sobel in one call."""
    return sobel_edges(make_mask(lsm, ci), exact_lon=exact_lon)
