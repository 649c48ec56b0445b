"""Boundary index maps of the reference, and halo-padding built on them.

The reference handles grid boundaries by index arithmetic in three distinct
ways (all on 1-based Fortran indices):

* latitude rows are clamped:   ``ki = min(max(1, i), nlats)``
  (sobel.f90:67, seabreeze_diag_python.f90:201, sobel.f90:159)
* longitudes, "quirky" variant: ``kj = max(1, modulo(j, nlons))``
  (sobel.f90:68 in get_edges, seabreeze_diag_python.f90:202 in the ring
  search).  This is *not* clean periodicity: the column left of column 1
  clamps to column 1, and — because ``modulo(nlons, nlons) == 0`` — column
  nlons itself aliases to column 1 whenever reached through this map.
* longitudes, periodic variant: ``xx = modulo(j, nlons); if (xx==0) xx=nlons``
  (sobel.f90:163-164 in get_dist) — true periodic wraparound.

These maps are reproduced here on 0-based indices so that vectorized gathers
and halo pads are bit-identical index-wise to the Fortran loops.  The clean
periodic map is also offered for the non-exact mode (``Params.exact_lon_indexing
= False``) and for the distributed halo-exchange path, where the quirky map
only needs special-casing on the shards owning the global lon edges.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def lat_index_clamped(i, nlat: int):
    """0-based row map for the Fortran clamp min(max(1, i+1), nlat)."""
    return np.clip(i, 0, nlat - 1)


def lon_index_quirky(j, nlon: int):
    """0-based column map for Fortran ``max(1, modulo(j+1, nlons))``.

    ``j`` is a 0-based (possibly out-of-range) column index; Fortran sees the
    1-based ``j+1``.  Python ``%`` matches Fortran ``modulo`` for a positive
    divisor.
    """
    j = np.asarray(j)
    return np.maximum(1, (j + 1) % nlon) - 1


def lon_index_periodic(j, nlon: int):
    """0-based column map for true periodic wraparound (sobel.f90:163-164)."""
    j = np.asarray(j)
    return j % nlon


def pad_indices(n: int, pad: int, index_map) -> np.ndarray:
    """Indices selecting a (n + 2*pad)-wide padded axis from an n-wide axis,
    boundary-resolved through ``index_map``.  Static (NumPy) — shapes and
    gather indices are compile-time constants."""
    return np.asarray(index_map(np.arange(-pad, n + pad), n), np.int32)


def _take2(field, axis: int, idx: np.ndarray):
    """Gather fallback for degenerate pads (pad > n)."""
    return jnp.take(field, jnp.asarray(idx), axis=axis)


def pad2d(field, pad_lat: int, pad_lon: int, *, exact_lon: bool = True):
    """Pad a (..., nlat, nlon) field through the boundary index maps.

    Rows use the clamped map; columns use the quirky map when ``exact_lon``
    (reference parity) else the periodic map.  This is the single-device
    stand-in for a halo exchange: on a sharded mesh the same semantics are
    produced by ``parallel.halo.exchange`` plus this map applied only at the
    true global edges.

    Built from static slices + one concat per axis rather than ``jnp.take``:
    the boundary maps are piecewise-contiguous, so slices say the same thing
    as a general gather and leave XLA nothing to index dynamically.
    Index-for-index identical to gathering through ``pad_indices``:

      * clamped rows:   [row0] * p  ++  rows  ++  [row n-1] * p
      * quirky cols:    cols[n-p : n-1] ++ [col0]        (left pad)
                        ++ cols[0 : n-1] ++ [col0]       (center: col n-1
                          aliases col 0 — Fortran modulo(nlons,nlons)=0)
                        ++ cols[0 : p]                   (right pad)
      * periodic cols:  cols[n-p :] ++ cols ++ cols[: p]
    """
    nlat, nlon = field.shape[-2], field.shape[-1]
    out = field
    if pad_lat:
        if pad_lat > nlat:  # degenerate: fall back to the exact gather
            out = _take2(out, -2, pad_indices(nlat, pad_lat,
                                              lat_index_clamped))
        else:
            top = jnp.repeat(out[..., :1, :], pad_lat, axis=-2)
            bot = jnp.repeat(out[..., -1:, :], pad_lat, axis=-2)
            out = jnp.concatenate([top, out, bot], axis=-2)
    if pad_lon:
        lon_map = lon_index_quirky if exact_lon else lon_index_periodic
        if pad_lon > nlon - 1:
            out = _take2(out, -1, pad_indices(nlon, pad_lon, lon_map))
        elif exact_lon:
            first = out[..., :, :1]
            left = jnp.concatenate(
                [out[..., :, nlon - pad_lon:nlon - 1], first], axis=-1)
            center = jnp.concatenate([out[..., :, :nlon - 1], first],
                                     axis=-1)
            right = out[..., :, :pad_lon]
            out = jnp.concatenate([left, center, right], axis=-1)
        else:
            out = jnp.concatenate([out[..., :, nlon - pad_lon:], out,
                                   out[..., :, :pad_lon]], axis=-1)
    return out


def remap_lon_quirky(field):
    """Re-index the *unpadded* columns of a field through the quirky map.

    Needed because the quirky map is not the identity even for in-range
    columns: column nlons-1 (0-based) aliases to column 0 when addressed as
    the window *center* in get_edges/ring-search loops (Fortran
    ``modulo(nlons, nlons) == 0``).  ``pad2d`` already handles this for the
    padded copy; this helper exists for code that indexes centers directly.
    """
    return jnp.concatenate([field[..., :, :-1], field[..., :, :1]], axis=-1)
