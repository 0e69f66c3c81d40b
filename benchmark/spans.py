"""Reading the program's own profiler ranges (molclr_tpu_torch/train/
spans.py: `pretrain.*`, `graphed.*`, `step.*`) inside the
record_function range `marker` that brackets a profiled window.

For each range name: how many times it ran, its total and self time (the
duration less the part covered by its child program ranges), the
device's idle time while it was the innermost program range on the host,
and the device time of the kernels, copies and fills launched under it.
A device operation belongs to the innermost program range on the
marker's thread at the time of the runtime call that launched it (the
call and the operation share a correlation id in the profiler's events):
a graph replay's kernels fall under `graphed.replay`, and the backward's,
which autograd launches from its own thread, under the range the caller
waits in. Time outside every program range is under NONE.

`eager_block` profiles EAGER_STEPS eager pretraining steps under their
own marker, where the step's parts (`step.*`, inside a replay's graph
body and so never seen on a replay) are live; `readings` turns a
window's table and that block's into per-layer numbers.
"""

from __future__ import annotations

import bisect

import torch

PREFIXES = ("pretrain.", "graphed.", "step.")
NONE = "(no program range)"
FIELDS = ("count", "total_s", "self_s", "idle_s", "device_s")
EAGER_STEPS = 4
EAGER_MARK = "bench.eager_steps"


def is_program(name: str) -> bool:
    return name.startswith(PREFIXES)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(segs, starts, a, b) -> float:
    """Length of [a, b] inside the sorted disjoint segments."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    got = 0.0
    while i < len(segs) and segs[i][0] < b:
        got += max(0.0, min(b, segs[i][1]) - max(a, segs[i][0]))
        i += 1
    return got


def read(events, marker: str) -> dict:
    """{range name: {count, total_s, self_s, idle_s, device_s}} of the
    program ranges on the marker's thread inside the marker, with NONE
    (idle_s and device_s outside every program range), and "window"
    (window_s, idle_s, and device_s: every device operation in it)."""
    cuda = torch.autograd.DeviceType.CUDA
    mark = next((e for e in events if e.name == marker
                 and e.device_type != cuda), None)
    if mark is None:
        raise RuntimeError(f"profiler: no {marker!r} range in the trace")
    lo, hi = mark.time_range.start, mark.time_range.end
    dev = [(max(e.time_range.start, lo), min(e.time_range.end, hi), e)
           for e in events if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)
           and e.name != marker
           and e.time_range.end > lo and e.time_range.start < hi]
    idle, prev = [], lo
    for a, b in _union([(a, b) for a, b, _ in dev]) + [[hi, hi]]:
        if a > prev:
            idle.append([prev, a])
        prev = max(prev, b)
    starts = [a for a, _ in idle]

    host = [e for e in events if e.device_type != cuda
            and e.thread == mark.thread and is_program(e.name)
            and lo <= e.time_range.start and e.time_range.end <= hi]
    host.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
    # each range's direct children, from the nesting of the intervals
    children = {id(e): [] for e in host}
    stack = []
    for e in host:
        while stack and stack[-1].time_range.end <= e.time_range.start:
            stack.pop()
        if stack:
            children[id(stack[-1])].append(e)
        stack.append(e)
    # the host timeline as (start, end, innermost range) segments
    segs = []
    for e in host:
        at = e.time_range.start
        for k in children[id(e)]:
            segs.append((at, k.time_range.start, e.name))
            at = k.time_range.end
        segs.append((at, e.time_range.end, e.name))
    segs.sort()
    seg_starts = [a for a, _, _ in segs]

    table = {}

    def row(name):
        return table.setdefault(name, dict.fromkeys(FIELDS, 0.0))

    for e in host:
        r = row(e.name)
        r["count"] += 1
        r["total_s"] += (e.time_range.end - e.time_range.start) * 1e-6
    for a, b, name in segs:
        r = row(name)
        r["self_s"] += (b - a) * 1e-6
        r["idle_s"] += _overlap(idle, starts, a, b) * 1e-6
    total_idle = sum(b - a for a, b in idle) * 1e-6
    row(NONE)["idle_s"] = total_idle - sum(
        r["idle_s"] for n, r in table.items() if n != NONE)

    def innermost(t):
        i = bisect.bisect_right(seg_starts, t) - 1
        return segs[i][2] if i >= 0 and t <= segs[i][1] else NONE

    # a device operation belongs to the range around the runtime call that
    # launched it (the same correlation id; a graph's kernels, that of its
    # launch), on whichever thread: autograd launches the backward's
    # kernels from its own thread while the caller waits in its range
    launch = {e.id: e.time_range.start for e in events
              if e.device_type != cuda and e.name.startswith("cu")}
    for a, b, e in dev:
        t = launch.get(e.id)
        row(NONE if t is None else innermost(t))["device_s"] += \
            (b - a) * 1e-6
    for r in table.values():
        r["count"] = int(r["count"])
    table["window"] = {"window_s": (hi - lo) * 1e-6, "idle_s": total_idle,
                       "device_s": sum(b - a for a, b, _ in dev) * 1e-6}
    return table


def idle_lines(table: dict) -> list[str]:
    """The device's idle time by innermost program range, largest first,
    each with its share of the window's idle time."""
    total = table["window"]["idle_s"]
    rows = sorted(((r["idle_s"], n) for n, r in table.items()
                   if n != "window" and r["idle_s"] > 0), reverse=True)
    out = [f"idle {1e3 * total:.3f} ms of a {1e3 * table['window']['window_s']:.3f}"
           f" ms window, by innermost program range:"]
    for s, n in rows:
        out.append(f"  {n:<22} {1e3 * s:10.3f} ms "
                   f"{100.0 * s / total if total else 0.0:6.2f} %")
    return out


def named_idle_share(table: dict) -> float | None:
    """The share (%) of the window's device idle time that falls under a
    program range."""
    total = table["window"]["idle_s"]
    if not total:
        return None
    return 100.0 * (1.0 - table.get(NONE, {}).get("idle_s", 0.0) / total)


def _get(table, name, field):
    r = table.get(name) if table else None
    return r[field] if r and r["count"] else None


def eager_block(ctx, pt) -> dict:
    """The table of EAGER_STEPS eager `_resident_step`s of the Pretrainer
    `pt` on the next epoch's first unit rows, with keys from one
    `_key_window`, profiled under EAGER_MARK (after one unprofiled eager
    step: the eager path's first call after many replays pays its set-up
    once). The steps change `pt`'s state: run it after the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.loops.pretrain import _sync

    dev = ctx.device
    epoch = pt.step // pt.steps_per_epoch
    rows = torch.as_tensor(pt._unit_orders(epoch)[:EAGER_STEPS],
                           dtype=torch.long, device=dev)
    keys = pt._key_window(pt.step, EAGER_STEPS)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    pt._resident_step(rows[0], keys[0], pt.schedule(pt.step))
    _sync(dev)
    with profile(activities=acts) as prof:
        torch.ones(1, device=dev).add_(1)
        _sync(dev)
        with record_function(EAGER_MARK):
            for j in range(EAGER_STEPS):
                pt._resident_step(rows[j], keys[j], pt.schedule(pt.step))
            _sync(dev)
    return read(prof.events(), EAGER_MARK)


def readings(window: dict | None, steps: int,
             eager: dict | None = None) -> dict:
    """The per-layer numbers of a pretraining window's table (`steps`
    profiled steps, one validation pass) and of eager_block's table (None
    where a range is missing): validation ms in the window, the
    Pretrainer's own host ms per dispatched step (pretrain.dispatch's self
    time), augmentation device ms per eager step (kernels under
    step.views); with the share of the window's idle time under a program
    range, the eager step's device ms and each part's, the parts' share of
    it, and a replay's device ms."""
    def per(v, n):
        return None if v is None or not n else 1e3 * v / n

    out = {
        "valid_ms_per_epoch": per(_get(window, "pretrain.validate",
                                       "total_s"), 1),
        "dispatch_ms_per_step": per(_get(window, "pretrain.dispatch",
                                         "self_s"), steps),
        "aug_ms_per_step": per(_get(eager, "step.views", "device_s"),
                               EAGER_STEPS),
        "named_idle_share": named_idle_share(window) if window else None,
        "device_ms_per_replay": per(_get(window, "graphed.replay",
                                         "device_s"),
                                    _get(window, "graphed.replay", "count")),
    }
    if eager:
        parts = {n: r["device_s"] for n, r in eager.items()
                 if n.startswith("step.")}
        total = eager["window"]["device_s"]
        out["eager_step_device_ms"] = per(total, EAGER_STEPS)
        out["eager_part_ms"] = {n: per(v, EAGER_STEPS)
                                for n, v in sorted(parts.items())}
        out["eager_parts_share"] = (100.0 * sum(parts.values()) / total
                                    if total else None)
    return out
