"""What a traced stretch of the window records, read from torch.profiler.

The profiler records the card's activity (kernels, copies, sets) and the
host's operators; the benchmark marks each request it sends with a
``record_function`` span of the name ``REQUEST``.  The raw kineto events
are read directly: torch builds its own event tree only when asked, which
takes minutes at a million events.

Device time is the union of the device's activity intervals, so work that
overlaps on several streams counts once, and copies count as busy.
"""

from __future__ import annotations

import bisect
import collections

REQUEST = "perfbench.request"
_COPY_PREFIXES = ("Memcpy", "Memset")


def union(intervals) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(merged, lo: int, hi: int) -> int:
    """Length of the merged intervals inside [lo, hi)."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


def is_copy(name: str) -> bool:
    return name.startswith(_COPY_PREFIXES)


def _host_op_at(host, starts, t: int, look_back: int = 256) -> str:
    """The innermost host operator running at time t: the latest-starting
    of those that contain it (within the last `look_back` to start)."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(host[max(0, i - look_back):i]):
        if e > t:
            return name
    return "host: between operators"


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", lambda: False)())


def start(cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def stop(prof) -> dict:
    """The stretch's raw records: requests, device activity and host
    operators, each as (name, start_ns, end_ns)."""
    from torch.autograd import DeviceType
    prof.__exit__(None, None, None)
    requests, device, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        begin = e.start_ns()
        end = begin + e.duration_ns()
        if e.name() == REQUEST:
            if e.device_type() == DeviceType.CPU:
                requests.append((begin, end))
        elif e.device_type() == DeviceType.CUDA:
            # annotations on the device's timeline (the request's span,
            # the collectives' "nccl:..." spans) cover activity, and are
            # none themselves
            if end > begin and not _annotation(e):
                device.append((e.name(), begin, end))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), begin, end))
    requests.sort()
    return {"requests": requests, "device": device, "host": host}


def reduce(raw: dict, br_kernels: list, top: int = 10) -> dict:
    """The stretch's summary, the form the metric readers read: each
    request's wall and device-busy ns, the busy union over the stretch,
    kernel and copy counts, the blind-rotate kernels' union, and the
    breakdown (device operations by time, idle gaps by host operator)."""
    reqs = raw["requests"]
    if not reqs:
        return {"requests": 0}
    lo, hi = reqs[0][0], max(e for _, e in reqs)
    inside = [(n, s, e) for n, s, e in raw["device"] if e > lo and s < hi]
    merged = union([s, e] for _, s, e in inside)
    br = union([s, e] for n, s, e in inside
               if any(k in n for k in br_kernels))
    by_op = collections.Counter()
    for n, s, e in inside:
        by_op[n] += min(e, hi) - max(s, lo)
    gaps = collections.Counter()
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    host = sorted(raw["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        g0, g1 = max(g0, lo), min(g1, hi)
        if g1 > g0:
            gaps[_host_op_at(host, starts, (g0 + g1) // 2)] += g1 - g0
    return {
        "requests": len(reqs),
        "request_wall_ns": [e - s for s, e in reqs],
        "request_busy_ns": [covered(merged, s, e) for s, e in reqs],
        "window_ns": hi - lo,
        "busy_ns": covered(merged, lo, hi),
        "kernels": sum(1 for n, _, _ in inside if not is_copy(n)),
        "copies": sum(1 for n, _, _ in inside if is_copy(n)),
        "br_busy_ns": covered(br, lo, hi),
        "br_kernels": sum(1 for n, _, _ in inside
                          if any(k in n for k in br_kernels)),
        "device_ops": [[n, t / 1e9] for n, t in by_op.most_common(top)],
        "idle_gaps": [[n, t / 1e9] for n, t in gaps.most_common(top)],
    }
