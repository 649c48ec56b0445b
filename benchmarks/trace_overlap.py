#!/usr/bin/env python
"""Collective/compute overlap per GPU, read off a ``jax.profiler`` trace.

For every ``/device:GPU:N`` plane of the trace, the events on its stream
lines are split into communication — NCCL kernels and peer-to-peer copies,
which is what the halo ``ppermute`` exchanges become — and the rest
(compute kernels, device-local copies and memsets).  Reports per device:
the window, busy time (union of all events), communication time, and the
part of it during which nothing else runs on that device — the exposed
communication.

Usage::

    python benchmarks/trace_overlap.py TRACE_DIR   # e.g. from
    # python chip_smoke.py --four-gpus --trace-dir TRACE_DIR
"""
from __future__ import annotations

import glob
import json
import os
import sys


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(merged):
    return sum(e - s for s, e in merged)


def _minus(a, b):
    """Length of merged intervals ``a`` not covered by merged ``b``."""
    total, j = 0, 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                total += b[k][0] - cur
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            total += e - cur
    return total


def overlap(trace_dir):
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    report = {}
    for plane in ProfileData.from_file(sorted(paths)[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        comm, comp = [], []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                iv = (ev.start_ns, ev.start_ns + ev.duration_ns)
                is_comm = "nccl" in ev.name.lower() or "P2P" in ev.name
                (comm if is_comm else comp).append(iv)
        if not comm and not comp:
            continue
        comm_u, comp_u = _union(comm), _union(comp)
        busy = _union(comm + comp)
        report[plane.name] = {
            "window_us": (busy[-1][1] - busy[0][0]) / 1e3,
            "busy_us": _length(busy) / 1e3,
            "comm_us": _length(comm_u) / 1e3,
            "comm_exposed_us": _minus(comm_u, comp_u) / 1e3,
            "compute_us": _length(comp_u) / 1e3,
            "n_comm_events": len(comm),
        }
    return report


if __name__ == "__main__":
    print(json.dumps(overlap(sys.argv[1]), indent=1))
