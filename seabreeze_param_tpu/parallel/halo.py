"""Halo exchange — the JAX ``swap_bounds``.

Replaces the reference's MPI halo exchange (UM ``swap_bounds``,
``UM/vn10.7/sea_breeze_diag.F90:408-410, 531-545``; no-op stub
``generic/halo_exchange_mod.f90:8-18``) with ``jax.lax.ppermute`` shifts on
a ('y', 'x') mesh inside ``shard_map``, which XLA lowers to NCCL
collective-permutes between GPUs.  Longitude is periodic; latitude is
bounded, with the global-edge shards filling their missing halo locally
according to the reference's boundary semantics:

  * ``lat_fill='clamp'`` — replicate the global edge row (the Fortran
    ``min(max(1, i), nlats)`` clamp; sobel + ring search).
  * ``lat_fill='zero'``  — zeros (distance transform: out-of-grid rows are
    never coastline sources).

The reference's quirky lon map ``max(1, modulo(j, nlons))``
(sobel.f90:68, seabreeze_diag_python.f90:202) differs from clean
periodicity in exactly two places, both local to the seam shards after a
periodic exchange (see ops.indexing):

  * padded position -1 holds global column 0 (not n-1) — patched by the
    shard owning column 0;
  * interior position n-1 *aliases* to column 0 — patched by the shard
    owning column n-1 (its right halo's first column is column 0).

Two APIs:

* :func:`halo_pad` — the one-shot exchange (pad-and-return).
* :func:`halo_start` / :func:`halo_finish` — the SPLIT-PHASE exchange:
  ``halo_start`` issues all eight neighbor transfers (4 edges + 4 corners,
  each an independent ``ppermute``) and ``halo_finish`` assembles the
  padded block and applies the boundary fills/patches.  Independent compute
  traced between the two — e.g. the step's ``wind_at_level`` — is free to
  overlap the transfers; whether XLA's scheduler does so on a GPU is read
  off a trace (PERF.md), not assumed.  The reference UM's ``swap_bounds``
  sequence blocks on every exchange
  (``UM/vn10.7/sea_breeze_diag.F90:531-545``).

The corner blocks travel as separate two-hop ppermutes (x-shift then
y-shift of an (hy, hx) block) so that *all* transfers are issued up front;
the one-shot form instead runs y on the x-padded array (same values —
``halo_pad`` is implemented on the split-phase primitives).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .mesh import AXIS_Y, AXIS_X


def _shift_from_left(strip, axis_name, periodic):
    """Each shard receives its LEFT neighbor's strip (send right)."""
    n = lax.axis_size(axis_name)
    if n == 1:
        return strip if periodic else jnp.zeros_like(strip)
    perm = [(i, (i + 1) % n) for i in range(n if periodic else n - 1)]
    return lax.ppermute(strip, axis_name, perm)


def _shift_from_right(strip, axis_name, periodic):
    """Each shard receives its RIGHT neighbor's strip (send left)."""
    n = lax.axis_size(axis_name)
    if n == 1:
        return strip if periodic else jnp.zeros_like(strip)
    perm = [((i + 1) % n, i) for i in range(n if periodic else n - 1)]
    return lax.ppermute(strip, axis_name, perm)


class HaloParts(NamedTuple):
    """In-flight halo transfers from :func:`halo_start` (None where the
    corresponding width is zero)."""
    left: object = None
    right: object = None
    top: object = None
    bot: object = None
    tl: object = None
    tr: object = None
    bl: object = None
    br: object = None


def halo_start(local, hy: int, hx: int, *, axis_y: str = AXIS_Y,
               axis_x: str = AXIS_X) -> HaloParts:
    """Issue all eight halo transfers for a local (..., h, w) block.

    Every edge strip and corner block is an independent ``ppermute`` (the
    corners two-hop: x-shift then y-shift of an (hy, hx) block), so XLA can
    run them all concurrently and overlap them with whatever compute is
    traced between this call and :func:`halo_finish`.
    """
    p = {}
    if hx:
        p["left"] = _shift_from_left(local[..., :, -hx:], axis_x, True)
        p["right"] = _shift_from_right(local[..., :, :hx], axis_x, True)
    if hy:
        p["top"] = _shift_from_left(local[..., -hy:, :], axis_y, False)
        p["bot"] = _shift_from_right(local[..., :hy, :], axis_y, False)
    if hy and hx:
        p["tl"] = _shift_from_left(
            _shift_from_left(local[..., -hy:, -hx:], axis_x, True),
            axis_y, False)
        p["tr"] = _shift_from_left(
            _shift_from_right(local[..., -hy:, :hx], axis_x, True),
            axis_y, False)
        p["bl"] = _shift_from_right(
            _shift_from_left(local[..., :hy, -hx:], axis_x, True),
            axis_y, False)
        p["br"] = _shift_from_right(
            _shift_from_right(local[..., :hy, :hx], axis_x, True),
            axis_y, False)
    return HaloParts(**p)


def quirky_seam_patch(out, hx: int, w: int, *, axis_x: str = AXIS_X):
    """Apply the reference's quirky-lon seam patches to an x-padded block.

    ``out`` is (..., *, w + 2*hx) with a periodic x exchange already in
    place; ``w`` is the interior width.  Patches exactly the two positions
    where the quirky map ``max(1, modulo(j, nlons))`` differs from clean
    periodicity (see module docstring) — valid for hx < w (at hx == w the
    aliased column appears at a third, unpatched position in the opposite
    halo; ``ShardedPipeline`` guards this), and also for blocks whose
    values were *computed* on a periodic apron (the slot layout is
    positional).
    """
    x_idx = lax.axis_index(axis_x)
    nx = lax.axis_size(axis_x)
    # position -1 := global column 0 (own first interior column)
    patched_lo = out.at[..., :, hx - 1].set(out[..., :, hx])
    out = jnp.where(x_idx == 0, patched_lo, out)
    # interior position n-1 := global column 0 (right halo's first col)
    patched_hi = out.at[..., :, hx + w - 1].set(out[..., :, hx + w])
    return jnp.where(x_idx == nx - 1, patched_hi, out)


def halo_finish(local, parts: HaloParts, hy: int, hx: int, *,
                lat_fill: str = "clamp", exact_lon: bool = True,
                axis_y: str = AXIS_Y, axis_x: str = AXIS_X):
    """Assemble the (..., h + 2*hy, w + 2*hx) padded block from in-flight
    parts, applying the global-lat-edge fill and quirky-lon seam patches."""
    mid = local
    if hx:
        mid = jnp.concatenate([parts.left, local, parts.right], axis=-1)
    out = mid
    if hy:
        if hx:
            top = jnp.concatenate([parts.tl, parts.top, parts.tr], axis=-1)
            bot = jnp.concatenate([parts.bl, parts.bot, parts.br], axis=-1)
        else:
            top, bot = parts.top, parts.bot
        y_idx = lax.axis_index(axis_y)
        ny = lax.axis_size(axis_y)
        if lat_fill == "clamp":
            top_fill = jnp.repeat(mid[..., :1, :], hy, axis=-2)
            bot_fill = jnp.repeat(mid[..., -1:, :], hy, axis=-2)
            top = jnp.where(y_idx == 0, top_fill, top)
            bot = jnp.where(y_idx == ny - 1, bot_fill, bot)
        elif lat_fill != "zero":
            raise ValueError(lat_fill)
        out = jnp.concatenate([top, mid, bot], axis=-2)
    if hx and exact_lon:
        out = quirky_seam_patch(out, hx, local.shape[-1], axis_x=axis_x)
    return out


def halo_pad(local, hy: int, hx: int, *, lat_fill: str = "clamp",
             exact_lon: bool = True, axis_y: str = AXIS_Y,
             axis_x: str = AXIS_X):
    """Attach hy/hx-wide halos to a local (..., h, w) block inside shard_map.

    Returns (..., h + 2*hy, w + 2*hx).  One-shot form of
    :func:`halo_start` + :func:`halo_finish`.
    """
    parts = halo_start(local, hy, hx, axis_y=axis_y, axis_x=axis_x)
    return halo_finish(local, parts, hy, hx, lat_fill=lat_fill,
                       exact_lon=exact_lon, axis_y=axis_y, axis_x=axis_x)


def swap_bounds(field, halo_size: int, **kw):
    """Name-compatible alias for the reference's ``swap_bounds`` contract
    (generic/halo_exchange_mod.f90:8): symmetric halo in both dims."""
    return halo_pad(field, halo_size, halo_size, **kw)
