"""Multi-host (multi-process) execution — the DCN layer.

The reference UM runs MPI-decomposed across nodes, with ``swap_bounds``
crossing node boundaries transparently (``UM/vn10.7/sea_breeze_diag.F90:
408-410``; SURVEY §5.8).  The JAX equivalent: one JAX process per host,
``jax.distributed.initialize`` for the coordination runtime, a global
('y', 'x') mesh over all processes' devices, and the SAME ``shard_map``
pipeline — XLA sends the shard-boundary ppermutes through NCCL, over NVLink
between the GPUs of a host and over the network between hosts, with no code
difference.

The feeding side is what actually changes at scale: a host must never
materialize the global 0.1-degree arrays.  :meth:`DistributedRunner.run`
feeds ``jax.make_array_from_process_local_data`` with each process's LOCAL
row block only, and returns per-process local output blocks.

Usage (one process per host; also works single-process as a no-op layer)::

    from seabreeze_param_tpu.parallel import distributed as dist
    dist.initialize()                       # env-driven, no-op if single
    mesh = dist.make_multihost_mesh()       # y axis split across processes
    sp = ShardedPipeline(pipe, mesh)
    runner = dist.DistributedRunner(sp)
    final, outs = runner.run(state_local, theta_local, ..., lsm_local, ...)

Verified by ``tests/test_multihost.py``: two CPU processes (4 virtual
devices each) over Gloo produce bit-identical results to the
single-process run.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.state import TriggerState
from .mesh import AXIS_Y, AXIS_X, make_mesh
from .sharded import ShardedPipeline, _pad_lat_host


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, **kw) -> None:
    """Start the JAX distributed runtime (no-op when single-process).

    Arguments default to the standard env vars
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``); nothing on a plain GPU host announces a cluster,
    so a multi-process launch sets them (or passes the arguments).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return      # single-process: nothing to coordinate
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)


def make_multihost_mesh(shape: tuple[int, int] | None = None):
    """Global ('y', 'x') mesh with each process's devices CONTIGUOUS along
    'y' (lat): the y-exchange at a process boundary is then the only
    inter-host crossing, and every x-exchange stays within a host
    (NVLink).

    Default shape: y = num_processes * (per-host y), near-square within the
    host.  ``jax.devices()`` orders devices by process, so a plain reshape
    gives the contiguous-by-process layout.
    """
    devices = jax.devices()
    nproc = jax.process_count()
    per = len(devices) // nproc
    if shape is None:
        # within a host: near-square (smallest shard perimeter, i.e. fewest
        # halo bytes), the extra factor on x (lon, usually the longer axis)
        py = int(np.floor(np.sqrt(per)))
        while per % py:
            py -= 1
        shape = (nproc * py, per // py)
    if shape[0] % nproc:
        # DistributedRunner's local-feeding contract is row-contiguous
        # process ownership: the y axis must split evenly over processes
        # (x-split layouts would interleave processes within a row block).
        raise ValueError(
            f"mesh shape {shape} cannot split y={shape[0]} contiguously "
            f"over {nproc} processes")
    return make_mesh(shape, devices=devices)


@dataclasses.dataclass
class DistributedRunner:
    """Per-process local-shard feeding for a :class:`ShardedPipeline`.

    Each process passes only the rows its devices own (the global lat axis
    is split contiguously by process under :func:`make_multihost_mesh`);
    outputs come back as this process's local row block.  Single-process,
    this degrades to exactly ``ShardedPipeline.run``'s behavior.
    """

    sp: ShardedPipeline

    def __post_init__(self):
        mesh = self.sp.mesh
        self.fld = NamedSharding(mesh, P(AXIS_Y, AXIS_X))
        self.repl = NamedSharding(mesh, P())
        self.nlat_pad = self.sp.nlat_pad
        self.nlon = self.sp.pipeline.grid.nlon
        # global row range owned by this process (contiguous by construction)
        idx_map = self.fld.addressable_devices_indices_map(
            (self.nlat_pad, self.nlon))
        spans = sorted({(idx[0].start, idx[0].stop)
                        for idx in idx_map.values()})
        self.row_lo = spans[0][0]
        self.row_hi = spans[-1][1]
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            if e0 != s1:
                raise ValueError(
                    "process row ownership is not contiguous; build the "
                    "mesh with make_multihost_mesh")
        # Full-width ownership: for every owned row span this process must
        # hold ALL longitude columns (an x-split-across-processes layout
        # would otherwise leave silent zero holes in local outputs).
        for lo, hi in spans:
            cols = sorted({(idx[1].start, idx[1].stop)
                           for idx in idx_map.values()
                           if idx[0].start == lo})
            covered = 0
            for c0, c1 in cols:
                if c0 != covered:
                    break
                covered = c1
            if covered != self.nlon:
                raise ValueError(
                    "process does not own full longitude rows; build the "
                    "mesh with make_multihost_mesh (y split by process)")

    # ------------------------------------------------------------------
    def _global(self, local, sharding, global_shape):
        return jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(local), global_shape)

    def _replicated(self, data):
        """Fully-replicated global array from host data (works for scalars,
        which make_array_from_process_local_data rejects)."""
        data = np.asarray(data)
        return jax.make_array_from_callback(
            data.shape, self.repl, lambda idx: data[idx])

    def _field(self, local, lead=()):
        """Distribute a (*lead, local_rows, nlon) block (already lat-padded
        rows for the LAST process)."""
        gshape = tuple(lead) + (self.nlat_pad, self.nlon)
        spec = P(*([None] * len(lead)), AXIS_Y, AXIS_X)
        return self._global(local, NamedSharding(self.sp.mesh, spec), gshape)

    def pad_rows_local(self, arr, axis=-2):
        """Lat replication-padding, applied only to the last process's
        block (the padding rows live at the global bottom)."""
        arr = np.asarray(arr)
        n_here = arr.shape[axis]
        want = self.row_hi - self.row_lo
        if self.row_hi == self.nlat_pad and \
                self.nlat_pad != self.sp.nlat_real:
            want_real = want - (self.nlat_pad - self.sp.nlat_real)
            if n_here == want_real:
                return _pad_lat_host(arr, want, axis=axis)
        return arr

    # ------------------------------------------------------------------
    def run(self, state: TriggerState, theta_t, u_t, v_t, lsm, z, std, pres,
            ci_t=None):
        """Like :meth:`ShardedPipeline.run` but every field argument is this
        process's LOCAL row block (global rows [row_lo, row_hi), before lat
        replication-padding) and outputs are returned as local blocks."""
        pad = self.pad_rows_local
        has_ci = ci_t is not None
        T = np.asarray(theta_t).shape[0]
        xs = (self._field(pad(np.asarray(theta_t, np.float32)), (T,)),
              self._field(pad(np.asarray(u_t, np.float32)),
                          np.asarray(u_t).shape[:2]),
              self._field(pad(np.asarray(v_t, np.float32)),
                          np.asarray(v_t).shape[:2]))
        if has_ci:
            xs = xs + (self._field(pad(np.asarray(ci_t, np.float32)), (T,)),)
        state_p = TriggerState(
            tt=self._replicated(np.asarray(state.tt, np.int32)),
            thc=self._field(pad(np.asarray(state.thc, np.float32))),
            windspeed=self._field(pad(np.asarray(state.windspeed,
                                                 np.float32))),
            winddir=self._field(pad(np.asarray(state.winddir, np.float32))))
        pres_np = np.asarray(pres, np.float32)
        pres_3d = pres_np.ndim == 3
        pres_arg = (self._field(pad(pres_np), (pres_np.shape[0],))
                    if pres_3d else self._replicated(pres_np))
        args = (state_p, xs, self._field(pad(np.asarray(lsm, np.float32))),
                self._field(pad(np.asarray(z, np.float32))),
                self._field(pad(np.asarray(std, np.float32))),
                pres_arg,
                self._replicated(self.sp.tables[0]),
                self._replicated(self.sp.tables[1]),
                self._replicated(self.sp.tables[2]))
        final, outs = self.sp.build(has_ci, pres_3d)(*args)

        # assemble this process's local row block from addressable shards
        lo = self.row_lo
        hi = min(self.row_hi, self.sp.nlat_real)

        def local_block(garr, lead_axes):
            n = len(garr.shape)
            out = np.zeros(garr.shape[:lead_axes]
                           + (self.row_hi - lo,) + garr.shape[lead_axes + 1:],
                           np.float32)
            for s in garr.addressable_shards:
                idx = s.index
                r = idx[lead_axes]
                dst = ((slice(None),) * lead_axes
                       + (slice(r.start - lo, r.stop - lo),)
                       + idx[lead_axes + 1:])
                out[dst] = np.asarray(s.data)
            return out[..., : hi - lo, :] if lead_axes == 0 else (
                out[(slice(None),) * lead_axes + (slice(0, hi - lo),)])

        final_local = TriggerState(
            tt=np.asarray(final.tt),
            thc=local_block(final.thc, 0),
            windspeed=local_block(final.windspeed, 0),
            winddir=local_block(final.winddir, 0))
        outs_local = {k: local_block(v, 1) for k, v in outs.items()}
        return final_local, outs_local
