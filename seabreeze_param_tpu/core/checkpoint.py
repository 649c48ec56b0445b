"""Checkpoint / resume of the persistent trigger state.

The reference's checkpointing story is manual state threading: the driver
carries ``(tt, thc, windspeed, winddir)`` across monthly files
(``test_run.py:39-49``) and a rerun must re-enter ``diag`` with the saved
triple (``__init__.py:204-215`` warns when it is dropped).  Here that
contract is explicit: :class:`~.state.TriggerState` is a pytree,
checkpointed with **orbax** (async-capable, multi-host-safe) so a batch
run can resume mid-series after preemption (SURVEY §5.3-5.4).

Layout: one orbax step directory per save, step number = ``tt`` (the
global timestep counter), so ``latest_step`` IS the resume point.
"""
from __future__ import annotations

import os

import numpy as np

from .state import TriggerState


def _ocp():
    """orbax.checkpoint, or an error naming the optional extra it ships in
    (checkpointing is off the main path: only ``--ckpt_dir`` needs it)."""
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        raise ImportError(
            "checkpoint/resume needs orbax-checkpoint: install the 'ckpt' "
            "extra (pip install 'seabreeze-param-tpu[ckpt]')") from None
    return ocp


def _manager(directory: str, max_to_keep: int = 3):
    ocp = _ocp()
    return ocp.CheckpointManager(
        os.path.abspath(os.path.expanduser(directory)),
        options=ocp.CheckpointManagerOptions(max_to_keep=max_to_keep,
                                             create=True))


def save_state(directory: str, state: TriggerState, *, extra: dict = None,
               max_to_keep: int = 3, wait: bool = True) -> int:
    """Save ``state`` (and optional extra arrays) under its ``tt`` step.

    Returns the step number written.  Effectively synchronous even with
    ``wait=False``: the per-call manager's close() waits for the write
    (kept for signature stability; see save_state_sharded's note).
    """
    ocp = _ocp()
    step = int(np.asarray(state.tt))
    payload = {"state": dict(tt=np.asarray(state.tt),
                             thc=np.asarray(state.thc),
                             windspeed=np.asarray(state.windspeed),
                             winddir=np.asarray(state.winddir))}
    if extra:
        payload["extra"] = {k: np.asarray(v) for k, v in extra.items()}
    mgr = _manager(directory, max_to_keep)
    mgr.save(step, args=ocp.args.StandardSave(payload))
    if wait:
        mgr.wait_until_finished()
    mgr.close()
    return step


def restore_state(directory: str, step: int | None = None):
    """Restore ``(state, extra)`` from the given (default: latest) step.

    Returns ``(None, None)`` when no checkpoint exists — callers start the
    run fresh with ``TriggerState.zeros`` exactly as the reference driver
    does (``test_run.py:13-17``).
    """
    ocp = _ocp()
    mgr = _manager(directory)
    try:
        step = mgr.latest_step() if step is None else step
        if step is None:
            return None, None
        payload = mgr.restore(step)
    finally:
        mgr.close()
    s = payload["state"]
    state = TriggerState(
        tt=np.asarray(s["tt"]), thc=np.asarray(s["thc"], np.float32),
        windspeed=np.asarray(s["windspeed"], np.float32),
        winddir=np.asarray(s["winddir"], np.float32))
    return state, payload.get("extra")


def save_state_sharded(directory: str, state: TriggerState, *,
                       max_to_keep: int = 3) -> int:
    """Save a SHARDED state without gathering it to one host.

    The fields stay ``jax.Array``s; orbax writes each process's shards
    (multi-host-safe on a shared filesystem).  ``tt`` must be replicated
    (it always is — ``P()`` in the sharded pipeline).

    Synchronous: returns after the write completes (the per-call manager
    must be closed, and close() waits — a truly async variant would need a
    long-lived CheckpointManager owned by the caller)."""
    ocp = _ocp()
    step = int(np.asarray(state.tt))
    payload = {"state": dict(tt=state.tt, thc=state.thc,
                             windspeed=state.windspeed,
                             winddir=state.winddir)}
    mgr = _manager(directory, max_to_keep)
    mgr.save(step, args=ocp.args.StandardSave(payload))
    mgr.wait_until_finished()
    mgr.close()
    return step


def restore_state_sharded(directory: str, like: TriggerState,
                          step: int | None = None):
    """Restore directly INTO the sharding layout of ``like`` (a
    TriggerState of jax.Arrays or ShapeDtypeStructs carrying shardings) —
    each process reads only its shards.  Returns None when no checkpoint
    exists."""
    import jax
    ocp = _ocp()

    def absify(x):
        if hasattr(x, "sharding"):
            return jax.ShapeDtypeStruct(x.shape, x.dtype,
                                        sharding=x.sharding)
        return x

    target = {"state": dict(tt=absify(like.tt), thc=absify(like.thc),
                            windspeed=absify(like.windspeed),
                            winddir=absify(like.winddir))}
    mgr = _manager(directory)
    try:
        step = mgr.latest_step() if step is None else step
        if step is None:
            return None
        payload = mgr.restore(step, args=ocp.args.StandardRestore(target))
    finally:
        mgr.close()
    s = payload["state"]
    return TriggerState(tt=s["tt"], thc=s["thc"],
                        windspeed=s["windspeed"], winddir=s["winddir"])


def latest_step(directory: str):
    """The resume point, or None when the directory has no checkpoints."""
    _ocp()  # validates availability
    mgr = _manager(directory)
    try:
        return mgr.latest_step()
    finally:
        mgr.close()
