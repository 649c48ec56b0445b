"""Batch production driver — the ``test_run.py`` equivalent.

End-to-end pipeline (``python_wrapper/test_run.py:8-57``): config file ->
static metadata -> per-dated-file loop -> jitted diag over each file's time
axis -> CF netCDF output ``{prefix}sb_{date}.nc``, with the persistent
state triple threaded across files.

Run as::

    python -m seabreeze_param_tpu.cli.run --config=run.conf

CLI contract as the reference (``test_run.py:72-110``): ``--option=value``
pairs, ``--help`` prints usage; unknown options are passed through to
``diag`` as science-parameter overrides (e.g. ``--maxdist=250``).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from .. import api
from ..io import Config, Meta, read_nc


def main(config, progress=sys.stdout, ckpt_dir=None, save_every=1,
         max_retries=2, watchdog_s=None, metrics_file=None, **diag_kwargs):
    """Run the batch pipeline; returns the final (tt, thc, ws, wd) state.

    With ``ckpt_dir`` the per-file loop runs under the elastic-recovery
    runner (``utils.resilience``): the state is checkpointed every
    ``save_every`` files, transient failures retry from the last
    checkpoint, and a rerun pointed at the same directory resumes the
    series after the last completed file.
    """
    from ..core.state import TriggerState
    from ..io.native_nc import PrefetchPool

    from ..utils.metrics import StepMetrics

    # Multi-host production mode (the reference's decomposed MPI run,
    # UM/...F90:408-410): start the JAX distributed runtime when the
    # standard env vars are set (no-op single-process).  api.diag then
    # routes through the global-mesh DistributedRunner automatically;
    # every process reads the input files, only the primary writes.
    from ..parallel import distributed as dist
    dist.initialize()
    import jax
    primary = jax.process_index() == 0
    if not primary:
        progress = None
        metrics_file = None
    # ckpt_dir works multi-process too: the state arriving here is the
    # allgathered GLOBAL state (identical on every process), and orbax
    # coordinates the write through the initialized distributed runtime
    # (primary writes, built-in barriers) — requires the directory to be a
    # shared filesystem.  Note the in-run retry path assumes failures are
    # process-symmetric: a single-process exception inside a collective
    # needs a full relaunch, which then RESUMES from this directory — the
    # standard multi-host recovery cut.

    if watchdog_s and not ckpt_dir:
        # The watchdog's abort path re-enters the unit from the last
        # checkpoint; without a checkpoint directory there is nothing to
        # restore to, so the option would be silently inert.
        import warnings
        warnings.warn("watchdog_s requires ckpt_dir (the stall recovery "
                      "restores from checkpoint); ignoring watchdog_s")
    cfg = Config(config)
    meta = Meta(cfg)
    shape = (len(meta.lat), len(meta.lon))
    written = []
    metrics_stream = open(metrics_file, "a") if metrics_file else None
    metrics = StepMetrics(grid_points=shape[0] * shape[1],
                          stream=metrics_stream)
    invars = (cfg.vv, cfg.vu, cfg.vtheta, cfg.vci)
    pool = PrefetchPool(2)   # no-op when no native toolchain
    date_index = {t: i for i, t in enumerate(meta.dates)}

    def process(state, tstring):
        """One dated file: read -> diag -> CF output.  The recovery unit."""
        step = date_index[tstring]
        # Warm the NEXT file set into the page cache on native C++ threads
        # while this step computes (the reference reads cold and serially,
        # test_run.py:18-30).
        if step + 1 < len(meta.dates):
            nxt = meta.dates[step + 1]
            pool.prefetch(*(meta.input_path(v, nxt) for v in invars))
        f_sb = meta.input_path("sb", tstring)
        if progress:
            progress.write("Creating sea-breeze data for "
                           f"{os.path.basename(f_sb)} ... ")
            progress.flush()
        nc_data = read_nc(meta.input_path(cfg.vv, tstring),
                          meta.input_path(cfg.vu, tstring),
                          meta.input_path(cfg.vtheta, tstring),
                          meta.input_path(cfg.vci, tstring),
                          vv=cfg.vv, vu=cfg.vu, vtheta=cfg.vtheta,
                          vci=cfg.vci, vpres=cfg.vpres, vtime=cfg.vtime)
        t_start = time.perf_counter()
        tt, sb_con, thc, windspeed, winddir, outs = api.diag(
            int(state.tt), meta.landfrac, meta.z, meta.std, meta.lon,
            meta.lat, nc_data.pres, meta=nc_data,
            ws=np.asarray(state.windspeed), wd=np.asarray(state.winddir),
            thc=np.asarray(state.thc), full_output=True, **diag_kwargs)
        nsteps = int(np.asarray(sb_con).shape[0])
        metrics.record(time.perf_counter() - t_start, nsteps)
        if metrics_stream:
            # executable-cache stats: after the first file these should be
            # all hits — a miss on a later file means a re-trace (e.g. the
            # ring bound grew); see api._EXEC_CACHE
            metrics.add(file=os.path.basename(f_sb),
                        exec_cache_hits=api.CACHE_STATS["pipeline_hits"],
                        exec_cache_misses=api.CACHE_STATS["pipeline_misses"])
            metrics.emit()
        if primary:
            meta.create_nc(np.asarray(sb_con), f_sb, "sb_con", nc_data.time)
            # per-step sea-level temperature, under the reference's
            # production name "thc" (the out[1] quirk — plot.py:97-99 reads
            # it from the sb files; the reference's own test_run.py never
            # wrote it)
            meta.create_nc(outs["t0"], f_sb, "thc", nc_data.time)
            written.append(f_sb)
        for f in nc_data.nc.values():
            f.close()
        if progress:
            progress.write("ok\n")
            progress.flush()
        return TriggerState(tt=np.int32(tt),
                            thc=np.asarray(thc, np.float32),
                            windspeed=np.asarray(windspeed, np.float32),
                            winddir=np.asarray(winddir, np.float32))

    state = TriggerState(tt=np.int32(1),
                         thc=np.zeros(shape, np.float32),
                         windspeed=np.zeros(shape, np.float32),
                         winddir=np.zeros(shape, np.float32))
    try:
        if ckpt_dir:
            from ..utils.resilience import run_resilient
            state, _ = run_resilient(
                list(meta.dates), process, state, str(ckpt_dir),
                save_every=int(save_every), max_retries=int(max_retries),
                watchdog_deadline_s=(float(watchdog_s) if watchdog_s
                                     else None))
        else:
            for tstring in meta.dates:
                state = process(state, tstring)
    finally:
        pool.close()
        if metrics_stream:
            metrics_stream.close()
    return (int(state.tt), np.asarray(state.thc),
            np.asarray(state.windspeed), np.asarray(state.winddir), written)


HELP = """
Batch driver for the sea-breeze trigger pipeline.

Usage:
    python -m seabreeze_param_tpu.cli.run --option=value

Options:
    config           : path to the run configuration (data directory, static
                       files, variable names, date range; default: ./run.conf)
    ckpt_dir         : checkpoint directory; enables elastic recovery +
                       resume across reruns (default: off)
    save_every       : checkpoint cadence in files (default: 1)
    max_retries      : transient-failure retries per file (default: 2)
    watchdog_s       : liveness deadline in seconds — a file making no
                       progress for this long is aborted (async exception
                       in the runner thread; a dispatch hung inside the
                       device runtime instead needs a process-level restart,
                       which resumes from the checkpoint) and retried from
                       the last checkpoint.  Requires ckpt_dir (default: off)
    metrics_file     : append one JSON metrics line per processed file
                       (per-step wall time, grid-points/s; default: off)
    mesh             : device mesh for sharded execution — "auto" (all
                       local devices) or "PYxPX", e.g. --mesh=2x4
                       (default: single device).  In a multi-process launch
                       (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
                       JAX_PROCESS_ID set, one process per host) the driver
                       always runs the decomposed multi-host pipeline over
                       ALL processes' devices; mesh then fixes the global
                       shape.  Every process reads the inputs; process 0
                       writes the outputs.
    any diag kwarg   : science-parameter override, e.g. --maxdist=250
"""


def cli(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kwargs = {"config": os.path.join(os.getcwd(), "run.conf")}
    for arg in argv:
        try:
            key, value = arg.lstrip("-").split("=")
        except ValueError:
            sys.exit(HELP)
        if key.lower() == "help":
            sys.exit(HELP)
        if value.lower() in ("true", "false"):
            value = value.lower() == "true"
        else:
            try:
                value = float(value)
            except ValueError:
                pass
        kwargs[key.lower()] = value
    main(**kwargs)


if __name__ == "__main__":
    cli()
