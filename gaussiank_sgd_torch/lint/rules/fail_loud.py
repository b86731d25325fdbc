"""Rule: fail-loud (port of ``gaussiank_sgd_tpu/lint/rules/fail_loud.py``).

Repo convention (code-review r4): user-facing validation raises
``ValueError`` — a bare ``assert`` vanishes under ``python -O`` and a bare
``except:`` swallows everything including ``KeyboardInterrupt``. Internal
invariants that genuinely want an assert carry a suppression comment
explaining why.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import Finding, ModuleCtx

NAME = "fail-loud"
SEVERITY = "warning"


class Rule:
    name = NAME
    severity = SEVERITY
    description = ("bare except: and assert in library code (asserts vanish "
                   "under -O; raise ValueError instead)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield ctx.finding(
                    NAME, SEVERITY, node,
                    "bare `except:` swallows every exception including "
                    "KeyboardInterrupt/SystemExit; catch the specific "
                    "exception (or at minimum `except Exception`)")
            elif isinstance(node, ast.Assert):
                yield ctx.finding(
                    NAME, SEVERITY, node,
                    "`assert` is removed under python -O, silently "
                    "skipping this validation; raise ValueError (repo "
                    "convention, code-review r4) or suppress if this is "
                    "a true internal invariant")
