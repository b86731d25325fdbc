"""Reduce a ``torch.profiler`` Chrome trace of the profiled stretch to the
per-layer numbers.

* The stretch is the ``window`` range (a ``record_function`` the harness
  opens around the profiled steps); its host span is the window.
* Device activity is every kernel, memcpy and memset; busy time is the
  union of their intervals inside the window, on any stream.
* A kernel belongs to a layer range when the host call that launched it
  (the runtime or driver event with the kernel's correlation id) falls
  inside an instance of that range on the stretch's host thread, whatever
  thread launched it: autograd launches the backward's kernels from a
  thread of its own while the calling thread waits inside the range.
* Idle gaps are the window less the busy union; each is named by what the
  host thread was doing at its middle: the enclosing layer range, if any,
  and the innermost host event.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver", "runtime", "driver"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "runtime", "driver", "operator"}
TOP = 10
NAME_CHARS = 160      # a kernel's name is cut to this many characters


@dataclass
class Summary:
    window_s: float
    busy_s: float
    range_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _union(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def summarize(events: List[dict], window: str,
              ranges: Sequence[str]) -> Optional[Summary]:
    """The stretch's numbers, or None when the trace holds no ``window``
    range."""
    cat = [str(e.get("cat", "")).lower() for e in events]
    wins = [e for e, c in zip(events, cat)
            if c == "user_annotation" and e.get("name") == window]
    if not wins:
        return None
    win = wins[0]
    tid, w0 = win.get("tid"), float(win["ts"])
    w1 = w0 + float(win["dur"])
    dev = [e for e, c in zip(events, cat) if c in DEVICE_CATS]
    inside = [(max(float(e["ts"]), w0),
               min(float(e["ts"]) + float(e.get("dur", 0)), w1), e)
              for e in dev]
    inside = [(a, b, e) for a, b, e in inside if b > a]
    busy = _union((a, b) for a, b, _ in inside)
    launch = {}
    for e, c in zip(events, cat):
        corr = (e.get("args") or {}).get("correlation")
        if c in LAUNCH_CATS and corr is not None:
            launch[corr] = float(e["ts"])
    inst = defaultdict(list)
    for e, c in zip(events, cat):
        if (c == "user_annotation" and e.get("name") in ranges
                and e.get("tid") == tid):
            inst[e["name"]].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for spans in inst.values():
        spans.sort()
    range_us: Dict[str, float] = defaultdict(float)
    ops: Dict[str, float] = defaultdict(float)
    for a, b, e in inside:
        ops[str(e.get("name"))[:NAME_CHARS]] += b - a
        hit = launch.get((e.get("args") or {}).get("correlation"))
        for name, spans in inst.items():
            if hit is not None and _within(spans, hit):
                range_us[name] += b - a
    gaps = _gaps(busy, w0, w1)
    named = _name_gaps(gaps, events, cat, tid, inst)
    return Summary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        range_s={name: range_us.get(name, 0.0) * 1e-6 for name in ranges
                 if name in inst},
        device_ops=sorted(((n, v * 1e-6) for n, v in ops.items()),
                          key=lambda kv: -kv[1])[:TOP],
        idle_gaps=named)


def _within(spans: List[Tuple[float, float]], t: float) -> bool:
    """Whether ``t`` falls in one of the sorted, disjoint ``spans``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def _gaps(busy: List[Tuple[float, float]], w0: float,
          w1: float) -> List[Tuple[float, float]]:
    out, at = [], w0
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if w1 > at:
        out.append((at, w1))
    return out


def _innermost(host, starts, t: float) -> Optional[str]:
    """The name of the latest-starting host event in ``host`` (sorted by
    start) that still runs at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4096, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return None


def _name_gaps(gaps, events, cat, tid, inst) -> List[Tuple[str, float]]:
    """Each gap by the layer range around its middle and the innermost
    host event there: the stretch's thread's, else another thread's
    (autograd's, in the backward) marked ``[other thread]``."""
    by_thread: Dict[bool, list] = {True: [], False: []}
    for e, c in zip(events, cat):
        if c in HOST_CATS and not str(e.get("name")).startswith("gk."):
            by_thread[e.get("tid") == tid].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 str(e.get("name"))[:NAME_CHARS]))
    lists = []
    for mine in (True, False):
        host = sorted(by_thread[mine], key=lambda x: x[0])
        lists.append((host, [h[0] for h in host]))
    total: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = _innermost(*lists[0], mid)
        if inner is None:
            other = _innermost(*lists[1], mid)
            inner = "host" if other is None else f"[other thread] {other}"
        outer = next((name for name, spans in inst.items()
                      if _within(spans, mid)), None)
        total[f"{outer} > {inner}" if outer else inner] += (b - a) * 1e-6
    return sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
