"""Reduce a jax.profiler trace to device metrics: busy share and the device
operations that take the time.

Busy time is the union of the intervals in which any operation runs on a
device; the idle share is 1 - busy / window, where the window spans the
first to the last device event. Operation time is the sum of the device
durations of each (kernel, HLO op) pair; the HLO op names the XLA
instruction that launched the kernel (`command_buffer` when XLA ran it
inside a CUDA graph).

Usage: python -m benchmarks.trace_summary <trace dir> [top_n]
"""

from __future__ import annotations

import glob
import os
import sys
from collections import defaultdict


def union_length(intervals):
    """Total length covered by [start, end) intervals (any order)."""
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _hlo_op(event):
    for name, value in event.stats:
        if name == "hlo_op":
            return value
    return None


def device_events(path):
    """(all plane names, {plane name: [(line name, op name, start_ns,
    duration_ns)]} for the device planes) of the newest .xplane.pb under
    `path`; the op name is the kernel name plus its HLO op."""
    from jax.profiler import ProfileData
    files = sorted(glob.glob(os.path.join(path, "plugins", "profile", "*",
                                          "*.xplane.pb")),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {path}")
    data = ProfileData.from_file(files[-1])
    out = {}
    names = [plane.name for plane in data.planes]
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        out[plane.name] = [
            (line.name, f"{ev.name} [{_hlo_op(ev)}]", ev.start_ns,
             ev.duration_ns)
            for line in plane.lines for ev in line.events]
    return names, out


def summarize(path, top_n=15):
    """Busy share and top operations per device plane of a trace."""
    names, planes = device_events(path)
    report, result = [], {}
    for name, events in planes.items():
        # Kernels run on the stream lines; the other lines of a device
        # plane (module and op summaries) repeat the same time.
        lines = sorted({ln for ln, _, _, _ in events})
        streams = [e for e in events if e[0].startswith("Stream")] or events
        ivals = [(s, s + d) for _, _, s, d in streams]
        if not ivals:
            report.append(f"{name}: no events")
            continue
        window = max(e for _, e in ivals) - min(s for s, _ in ivals)
        busy = union_length(ivals)
        per_op, calls = defaultdict(float), defaultdict(int)
        for _, ev, _, d in streams:
            per_op[ev] += d
            calls[ev] += 1
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:top_n]
        result[name] = dict(window_ns=window, busy_ns=busy,
                            busy_share=busy / window if window else 0.0,
                            top=[(op, d, calls[op]) for op, d in top])
        report.append(f"{name}: lines {lines}")
        report.append(f"{name}: window {window / 1e6:.3f} ms, busy "
                      f"{busy / 1e6:.3f} ms, busy share "
                      f"{result[name]['busy_share']:.4f}, idle share "
                      f"{1 - result[name]['busy_share']:.4f}")
        for op, d in top:
            report.append(f"  {d / 1e6:10.4f} ms  "
                          f"{100 * d / max(busy, 1):6.2f}%  x{calls[op]:<5d} "
                          f"{op[:60]}{op[op.rfind(' ['):] if len(op) > 60 else ''}")
    if not planes:
        report.append(f"no device planes in the trace (planes: {names})")
    return dict(planes=result, report=report)


if __name__ == "__main__":
    top = int(sys.argv[2]) if len(sys.argv) > 2 else 15
    for row in summarize(sys.argv[1], top)["report"]:
        print(row)
