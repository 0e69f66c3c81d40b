"""Reading a torch.profiler window: the device's busy time (the union of
its kernel, copy and fill intervals), the device time of the port's
hand-written layer kernels (by namespace, `fbl::`; NT-Xent's `ntx::`
kernels run only at B >= 2,048, which no cell takes, and have no bound
in the roofline yet), the device operations that took the most time, and
the longest idle gaps labelled with what the host was doing during each."""

from __future__ import annotations

import torch

PORT_KERNELS = ("fbl::",)


def _union(intervals):
    """Merged [start, end] segments of a list of intervals (us)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, marker: str) -> dict:
    """busy_s, the port's kernel seconds and launches, the top device ops
    and the longest idle gaps inside the record_function range `marker`
    (which brackets the profiled sub-window on the host)."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    lo = hi = None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # a record_function range on the device's timeline spans
            # kernels counted in their own rows
            if not getattr(e, "is_user_annotation", False) \
                    and e.name != marker:
                dev.append((start, end, e.name))
        else:
            if e.name == marker:
                lo, hi = start, end
            else:
                cpu.append((start, end, e.name))
    if lo is None:
        raise RuntimeError(f"profiler: no {marker!r} range in the trace")
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    segs = _union([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in segs)
    by_name, port_us, port_n = {}, 0.0, 0
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
        if any(k in n for k in PORT_KERNELS):
            port_us += b - a
            port_n += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    prev = lo
    for a, b in segs + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (a + b)
        inside = [(e - s, n) for s, e, n in cpu if s <= mid <= e]
        name = min(inside)[1] if inside else "host: outside any traced op"
        labelled.append([name[:120], (b - a) * 1e-6])
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy_us * 1e-6,
            "port_kernel_s": port_us * 1e-6, "port_launches": port_n,
            "device_ops": [[n[:120], us * 1e-6] for n, us in top],
            "idle_gaps": labelled}
