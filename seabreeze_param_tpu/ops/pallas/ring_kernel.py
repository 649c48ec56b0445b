"""Pallas GPU kernel (Triton route): coastal-band expanding-ring THC search.

The ring search (``ops.ring_search.ring_thc_from_padded``; reference
data-dependent while loop ``seabreeze_diag_python.f90:187-221``) runs densely
in XLA: every ring radius nn = 1..NN updates three running-sum channels over
the whole grid.  Only the coastal band |cdist| <= maxdist is ever searched
(seabreeze_diag_python.f90:171), and most of its cells find both classes
within a few rings.  Skipping blocks without a coastal cell and stopping once
every coastal cell has latched are data-dependent, which XLA cannot express;
this kernel does both.

Layout: a 2-D grid of independent (block_rows, block_cols) blocks.  A block
loads its centre ``cdist``; with no coastal cell its ring loop runs zero
times and it stores zeros.  Otherwise it loops over nn with an early exit
once every coastal cell has found both classes.

Each ring's four edge sums are computed directly from shifted loads of the
padded inputs (served from L1/L2), in exactly the addition order of the XLA
form: the top/bottom rows are the horizontal running sum
``q0 + q-1 + q+1 + q-2 + q+2 ...`` and the left/right columns the vertical
one, and the window sum adds ``top, bot, left, right`` in that order, so the
result is bit-identical to the XLA path (on an H100 too: Triton's and XLA's
float32 division round alike there, see PERF.md).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_SENTINEL = np.float32(12000.0)

#: Block shape and warp count, chosen on an H100 (PERF.md, "Where the time
#: goes").
BLOCK_ROWS = 16
BLOCK_COLS = 64
NUM_WARPS = 4


def _kernel(t0_ref, cd_ref, cdc_ref, out_ref, *, nn_max: int, br: int,
            bc: int, maxdist: float):
    NN = int(nn_max)
    r0 = pl.program_id(0) * br
    c0 = pl.program_id(1) * bc
    # The target cell's class and coastal predicate come from the UNPADDED
    # centre: the quirky lon pad remaps the last column inside the padded
    # copy, but the reference reads the target unremapped
    # (seabreeze_diag_python.f90:171, 220).
    cdc = plgpu.load(cdc_ref.at[pl.ds(r0, br), pl.ds(c0, bc)])
    coastal = jnp.abs(cdc) <= jnp.float32(maxdist)

    def q(dr, dc):
        """The three summands (t0*land, land, t0*sea) at offset (dr, dc)
        from every target of the block (ops.ring_search.ring_quantities)."""
        rows = pl.ds(r0 + NN + dr, br)
        cols = pl.ds(c0 + NN + dc, bc)
        t = plgpu.load(t0_ref.at[rows, cols])
        land = (plgpu.load(cd_ref.at[rows, cols]) >= 0.0).astype(jnp.float32)
        tl = t * land
        return tl, land, t - tl

    def add(a, b):
        return tuple(x + y for x, y in zip(a, b))

    def row_sum(dr, nn):
        """Horizontal running sum of order nn on row offset dr."""
        return lax.fori_loop(1, nn + 1,
                             lambda d, acc: add(add(acc, q(dr, -d)), q(dr, d)),
                             q(dr, 0))

    def col_sum(dc, nn):
        """Vertical running sum of order nn-1 on column offset dc."""
        return lax.fori_loop(1, nn,
                             lambda d, acc: add(add(acc, q(-d, dc)), q(d, dc)),
                             q(0, dc))

    def pending(found):
        return jnp.max(jnp.where(coastal & (found == 0.0), 1.0, 0.0)) > 0.0

    def cond(carry):
        nn, _, _, found = carry
        return (nn <= NN) & pending(found)

    def body(carry):
        nn, win, (tl_, nl_, ts_, ns_), found = carry
        parts = (row_sum(-nn, nn), row_sum(nn, nn), col_sum(-nn, nn),
                 col_sum(nn, nn))
        win = tuple((((w + a) + b) + c) + d
                    for w, a, b, c, d in zip(win, *parts))
        t_l, n_l, t_s = win
        side = (2 * nn + 1).astype(jnp.float32)
        n_s = side * side - n_l                      # exact (integers < 2^24)
        ok = (n_l > 0.0) & (n_s > 0.0)
        seen = found > 0.0
        # never-found cells take the NN window (only reachable when the loop
        # runs to NN; early exit means every coastal cell has latched)
        last = (ok & ~seen) | (~seen & (nn == NN))
        tl_ = jnp.where(last, t_l, tl_)
        nl_ = jnp.where(last, jnp.maximum(n_l, 1.0), nl_)
        ts_ = jnp.where(last, t_s, ts_)
        ns_ = jnp.where(last, jnp.maximum(n_s, 1.0), ns_)
        found = jnp.where(ok, 1.0, found)
        return nn + 1, win, (tl_, nl_, ts_, ns_), found

    zero = jnp.zeros((br, bc), jnp.float32)
    one = jnp.ones((br, bc), jnp.float32)
    carry = (jnp.int32(1), q(0, 0), (zero, one, zero, one), zero)
    _, _, (tl_, nl_, ts_, ns_), _ = lax.while_loop(cond, body, carry)
    mul = jnp.where(cdc >= 0.0, jnp.float32(1.0), jnp.float32(-1.0))
    n_thc = mul * (tl_ / nl_ - ts_ / ns_)
    plgpu.store(out_ref.at[pl.ds(r0, br), pl.ds(c0, bc)],
                jnp.where(coastal, n_thc, jnp.float32(0.0)))


def ring_thc_pallas(t0_pad, cd_pad, cd_center, nn_max: int, maxdist: float,
                    *, interpret: bool = False):
    """Coastal-band ring search on NN-padded fields.

    t0_pad, cd_pad : (h+2NN, w+2NN) f32 — padded sea-level temperature and
        signed coast distance (pad via the boundary maps single-device, or a
        halo exchange sharded).
    cd_center : (h, w) f32 — the unpadded signed coast distance (target class
        and coastal band).
    Returns n_thc (h, w), zero outside |cd_center| <= maxdist — the contract
    of ``ops.ring_search.ring_thc_from_padded(..., coastal=...)``.  The block
    shape and warp count are the module constants.
    """
    block_rows, block_cols = BLOCK_ROWS, BLOCK_COLS
    NN = int(nn_max)
    h, w = cd_center.shape
    if t0_pad.shape != (h + 2 * NN, w + 2 * NN) or cd_pad.shape != t0_pad.shape:
        raise ValueError(f"padded fields {t0_pad.shape}/{cd_pad.shape} do "
                         f"not match centre {(h, w)} with nn_max={NN}")
    ni, nj = -(-h // block_rows), -(-w // block_cols)
    dh, dw = ni * block_rows - h, nj * block_cols - w
    # Round the fields up to whole blocks so every load is in bounds.  Extra
    # centre cells carry the sentinel (never coastal); extra pad cells are
    # only read by those cells' windows.
    f32 = jnp.float32
    t0_pad = jnp.pad(jnp.asarray(t0_pad, f32), ((0, dh), (0, dw)))
    cd_pad = jnp.pad(jnp.asarray(cd_pad, f32), ((0, dh), (0, dw)),
                     constant_values=_SENTINEL)
    cd_center = jnp.pad(jnp.asarray(cd_center, f32), ((0, dh), (0, dw)),
                        constant_values=_SENTINEL)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    out = pl.pallas_call(
        functools.partial(_kernel, nn_max=NN, br=block_rows, bc=block_cols,
                          maxdist=float(maxdist)),
        out_shape=jax.ShapeDtypeStruct(cd_center.shape, f32),
        grid=(ni, nj),
        in_specs=[any_spec, any_spec, any_spec],
        out_specs=any_spec,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        backend="triton",
        name="ring_thc",
    )(t0_pad, cd_pad, cd_center)
    return out[:h, :w]
