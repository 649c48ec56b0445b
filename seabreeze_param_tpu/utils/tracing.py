"""Per-routine tracing — the DrHook equivalent.

The reference's UM variant wraps every routine in ECMWF DrHook enter/exit
calls with ``Module:Routine`` labels
(``UM/vn10.7/sea_breeze_diag.F90:64-65,140-142,172,324``).  The JAX
counterpart has two halves:

  * **device side** — ``jax.named_scope`` annotations that tag the XLA ops
    of each pipeline stage, so traces captured with ``jax.profiler`` show
    the same named call tree DrHook would print;
  * **host side** — a lightweight registry of wall-clock enter/exit
    timings (jit/compile boundaries, IO, host pre/post-processing), since
    device ops inside one fused XLA program cannot be host-timed
    individually.

Both are no-ops unless enabled, like DrHook's ``lhook`` guard
(``UM/...F90:172``).

Also here: :func:`device_info` — the introspection counterpart of the
reference's ``get_threads`` (``sobel.f90:195-206``), reporting the
parallel width of the backend (devices instead of OpenMP threads).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class _Record:
    calls: int = 0
    total_s: float = 0.0
    child_s: float = 0.0

    @property
    def self_s(self):
        return self.total_s - self.child_s


@dataclass
class Tracer:
    """DrHook-style named enter/exit tracer.

    >>> tracer = Tracer(enabled=True)
    >>> with tracer.hook("pipeline:distance"):
    ...     ...
    >>> tracer.report()   # per-label calls / total / self time
    """

    enabled: bool = False
    records: dict = field(default_factory=lambda: defaultdict(_Record))
    _stack: threading.local = field(default_factory=threading.local)

    @contextlib.contextmanager
    def hook(self, label: str):
        """Named scope: device-side annotation + host-side timing."""
        if not self.enabled:
            import jax
            with jax.named_scope(label):
                yield
            return
        import jax
        stack = getattr(self._stack, "frames", None)
        if stack is None:
            stack = self._stack.frames = []
        t0 = time.perf_counter()
        stack.append(label)
        try:
            with jax.named_scope(label):
                yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            rec = self.records[label]
            rec.calls += 1
            rec.total_s += dt
            if stack:
                self.records[stack[-1]].child_s += dt

    def report(self) -> str:
        """DrHook-style profile table, most expensive self-time first."""
        rows = sorted(self.records.items(), key=lambda kv: -kv[1].self_s)
        width = max([len(k) for k, _ in rows] + [7])
        lines = [f"{'routine':<{width}}  {'calls':>6} {'total_s':>9} "
                 f"{'self_s':>9}"]
        for label, rec in rows:
            lines.append(f"{label:<{width}}  {rec.calls:>6} "
                         f"{rec.total_s:>9.4f} {rec.self_s:>9.4f}")
        return "\n".join(lines)

    def reset(self):
        self.records.clear()


#: process-global default tracer (disabled: pure named_scope pass-through)
tracer = Tracer()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a full device profile (tensorboard-viewable) around a block."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_info() -> dict:
    """Backend parallel-width introspection (the ``get_threads`` analogue,
    sobel.f90:195-206): device count/kind replace OpenMP thread count."""
    import jax
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "num_devices": len(devs),
        "num_local_devices": jax.local_device_count(),
        "num_hosts": jax.process_count(),
        "device_kind": devs[0].device_kind,
    }


def require_gpu():
    """The local devices when JAX's default backend is a GPU; raises
    otherwise.  Measurement and on-card check paths call this so they never
    fall back to the CPU and report its numbers as the card's."""
    import jax
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {jax.default_backend()!r}")
    return jax.devices()


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (one line per card).
    A card set below its maximum power runs slower, so every measurement
    is reported beside this."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()
