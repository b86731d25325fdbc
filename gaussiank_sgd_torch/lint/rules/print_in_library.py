"""Rule: print-in-library (port of
``gaussiank_sgd_tpu/lint/rules/print_in_library.py``; names, severity and
message unchanged).

Library code must not write to stdout with bare ``print()``: stdout is a
machine-readable channel here (bench.py's one-JSON-line result,
the telemetry JSONL exporters) and a stray print corrupts it; diagnostics
belong on the logger (training/metrics.make_logger) or the telemetry bus
(docs/OBSERVABILITY.md).

Allowlisted: ``__main__.py`` CLI entrypoints (the lint and telemetry
CLIs — printing the report IS their job) and code under an
``if __name__ == "__main__":`` guard (script-mode self-tests never run
as library code).
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from ..core import Finding, ModuleCtx

NAME = "print-in-library"
SEVERITY = "warning"

# basenames whose whole file is a CLI entrypoint (its report output IS
# the product): gaussiank_sgd_torch/lint/__main__.py,
# gaussiank_sgd_torch/telemetry/__main__.py, ...
ALLOWED_BASENAMES = ("__main__.py",)


def _under_main_guard(ctx: ModuleCtx, node: ast.AST) -> bool:
    """True when ``node`` sits inside an ``if __name__ == "__main__":``
    block (either comparison order)."""
    for anc in ctx.ancestors(node):
        if not isinstance(anc, ast.If):
            continue
        test = anc.test
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], ast.Eq)):
            continue
        sides = (test.left, test.comparators[0])
        names = {s.id for s in sides if isinstance(s, ast.Name)}
        consts = {s.value for s in sides if isinstance(s, ast.Constant)}
        if "__name__" in names and "__main__" in consts:
            return True
    return False


class Rule:
    name = NAME
    severity = SEVERITY
    description = ("bare print() in library code (stdout is a machine "
                   "channel; use the logger or the telemetry bus)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if os.path.basename(ctx.path) in ALLOWED_BASENAMES:
            return
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"
                    and not _under_main_guard(ctx, node)):
                yield ctx.finding(
                    NAME, SEVERITY, node,
                    "bare `print()` writes to stdout from library code — "
                    "route diagnostics through the logger "
                    "(training/metrics.make_logger) or the telemetry bus "
                    "(docs/OBSERVABILITY.md); CLI report output belongs "
                    "in a __main__.py entrypoint")
