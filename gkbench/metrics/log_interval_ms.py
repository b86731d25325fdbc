"""The log boundary's host time: the trainer's ``log_interval`` span
(``_log_train``'s reductions and host reads, the bus record and its
JSONL write, the tracker, the policy tick and the rollback check), mean
ms over the steps that end a log interval among the window's steps before
the profiled stretch, from the program's own store (``--trace on``;
``gkbench/program_spans.py``). One step in ``log_every`` carries it: the
candidate for what sets ``step_ms_p95``."""

from gkbench.program_spans import outside_steps


def read(ctx):
    steps = outside_steps(ctx)
    if not steps:
        return None
    vals = [ms for ms in (e["ms"].get("log_interval") for e in steps)
            if ms is not None]
    return sum(vals) / len(vals) if vals else None
