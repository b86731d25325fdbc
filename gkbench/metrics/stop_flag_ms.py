"""The stop flag's host time: the trainer's ``stop_flag`` span
(``_stop_requested``: with several workers the flag's copy to the device,
its one-element all-reduce over NCCL and its read back, so a rank waits
there for the slowest rank's step), mean ms over the window's steps
before the profiled stretch that carry it, from the program's own store
(``--trace on``; ``gkbench/program_spans.py``)."""

from gkbench.program_spans import outside_steps


def read(ctx):
    steps = outside_steps(ctx)
    if not steps:
        return None
    vals = [ms for ms in (e["ms"].get("stop_flag") for e in steps)
            if ms is not None]
    return sum(vals) / len(vals) if vals else None
