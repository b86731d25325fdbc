"""gklint engine — findings, suppressions, module context, file walking
(port of ``gaussiank_sgd_tpu/lint/core.py``).

The linter is pure-AST (``ast`` + ``tokenize``): it never imports the code
it checks, so it runs without torch or a card and in O(ms) per file.
Rules live in ``lint/rules``; each is a small object with a ``name``, a
``severity``, and a ``check(ctx)`` generator over :class:`Finding`.

Suppression syntax (the reference's, unchanged):

  * trailing:      ``print(x)  # gklint: disable=print-in-library``
  * standalone (applies to the NEXT line)::

        # gklint: disable=fail-loud
        assert invariant, "..."

  * whole file:    ``# gklint: disable-file=<rule>[,<rule>...]``

``disable=all`` (or ``*``) suppresses every rule at that site.

Every suppression must carry a justification after ``--``::

    with self._lock:
        self._f.write(line)  # gklint: disable=conc-blocking-under-lock -- serialize dump+write

The CLI exits 2 on justification-less suppressions, and reports
suppressions that no longer mask any finding as stale (warnings by
default; findings under ``--strict-suppressions``).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import os
import re
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

SEVERITIES = ("error", "warning")

# rules part is a strict comma list of rule tokens so a ``-- justification``
# tail is never swallowed by the character class.
_SUPPRESS_RE = re.compile(
    r"#\s*gklint:\s*(disable|disable-file)\s*=\s*"
    r"([\w*][\w\-*]*(?:\s*,\s*[\w*][\w\-*]*)*)"
    r"(?:\s*--\s*(\S.*?)\s*$)?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, stable-fingerprinted for the baseline workflow.

    The fingerprint hashes (rule, path, stripped source text of the line)
    rather than the line NUMBER, so unrelated edits above a known finding
    do not turn it into a "new" one.
    """

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    source_line: str = ""
    end_line: int = 0

    @property
    def fingerprint(self) -> str:
        key = f"{self.rule}|{os.path.basename(self.path)}|" \
              f"{self.source_line.strip()}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule, "severity": self.severity, "path": self.path,
            "line": self.line, "col": self.col,
            "end_line": self.end_line or self.line,
            "message": self.message,
            "source": self.source_line.strip(),
            "fingerprint": self.fingerprint,
        }

    def human(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.severity}] {self.rule}: {self.message}")


@dataclasses.dataclass
class Suppression:
    """One ``# gklint: disable=...`` comment, tracked for staleness.

    ``target_line`` is the 1-based line the suppression masks (0 for
    file-wide). ``matched`` is flipped by :meth:`ModuleCtx.is_suppressed`
    whenever the entry actually masks a finding, so the CLI can report
    suppressions that no longer mask anything.
    """

    path: str
    line: int
    target_line: int
    kind: str  # "line" | "file"
    rules: frozenset
    justification: str
    source_line: str = ""
    matched: bool = False

    def to_json(self) -> Dict[str, object]:
        return {
            "path": self.path, "line": self.line,
            "target_line": self.target_line, "kind": self.kind,
            "rules": sorted(self.rules),
            "justification": self.justification,
            "matched": self.matched,
            "source": self.source_line.strip(),
        }


def parse_suppression_entries(source: str,
                              path: str = "<string>") -> List[Suppression]:
    """All suppression comments in ``source`` as :class:`Suppression` rows."""
    entries: List[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):  # half-written file
        return entries
    lines = source.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        kind, raw, just = m.group(1), m.group(2), m.group(3) or ""
        rules = {r.strip() for r in raw.split(",") if r.strip()}
        if "all" in rules or "*" in rules:
            rules = {"*"}
        row = tok.start[0]
        src = lines[row - 1] if row - 1 < len(lines) else ""
        if kind == "disable-file":
            entries.append(Suppression(
                path=path, line=row, target_line=0, kind="file",
                rules=frozenset(rules), justification=just,
                source_line=src))
            continue
        text_before = lines[row - 1][:tok.start[1]].strip() \
            if row - 1 < len(lines) else ""
        target = row if text_before else row + 1
        entries.append(Suppression(
            path=path, line=row, target_line=target, kind="line",
            rules=frozenset(rules), justification=just, source_line=src))
    return entries


def parse_suppressions(source: str):
    """(line -> rules) suppression maps from the comment stream.

    Returns ``(per_line, whole_file)`` where ``per_line`` maps a 1-based
    line number to the set of rule names suppressed there and
    ``whole_file`` is the set of file-wide suppressed rules.
    """
    per_line: Dict[int, Set[str]] = {}
    whole_file: Set[str] = set()
    for s in parse_suppression_entries(source):
        if s.kind == "file":
            whole_file |= s.rules
        else:
            per_line.setdefault(s.target_line, set()).update(s.rules)
    return per_line, whole_file


class ModuleCtx:
    """Everything a rule needs about one module: source, AST, parents
    and suppression maps."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.suppressions = parse_suppression_entries(source, path=path)
        self.suppressed_lines, self.suppressed_file = \
            parse_suppressions(source)
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                child._gklint_parent = parent  # type: ignore[attr-defined]

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_gklint_parent", None)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def src(self, node: ast.AST) -> str:
        line = getattr(node, "lineno", 0)
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""

    def finding(self, rule: str, severity: str, node: ast.AST,
                message: str) -> Finding:
        return Finding(rule=rule, severity=severity, path=self.path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0) + 1,
                       message=message, source_line=self.src(node),
                       end_line=getattr(node, "end_lineno", 0) or 0)

    def is_suppressed(self, f: Finding) -> bool:
        hit = False
        for s in self.suppressions:
            if not ({f.rule, "*"} & s.rules):
                continue
            if s.kind == "file" or s.target_line == f.line:
                s.matched = True
                hit = True
        return hit


def iter_py_files(paths: Sequence[str],
                  exclude_dirs: Iterable[str] = ("tests", ".git",
                                                 "__pycache__")) -> List[str]:
    out: List[str] = []
    excl = set(exclude_dirs)
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in excl)
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return out


def lint_source_detailed(source: str, path: str = "<string>", rules=None):
    """Lint one source string; return ``(findings, suppressions)``.

    The suppression rows have ``matched`` set when they masked a finding
    of this run — the raw material of the stale-suppression detector.
    """
    from .rules import ALL_RULES
    ctx = ModuleCtx(path, source)
    found: List[Finding] = []
    for rule in (rules if rules is not None else ALL_RULES):
        found.extend(f for f in rule.check(ctx) if not ctx.is_suppressed(f))
    found.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return found, ctx.suppressions


def lint_source(source: str, path: str = "<string>",
                rules=None) -> List[Finding]:
    """Lint one source string (the test/fixture entry point)."""
    return lint_source_detailed(source, path=path, rules=rules)[0]


def lint_paths_detailed(paths: Sequence[str], rules=None,
                        rel_to: Optional[str] = None):
    """:func:`lint_paths`, plus every suppression row seen along the way.

    Returns ``(findings, suppressions)``; suppression paths are made
    relative to ``rel_to`` like finding paths.
    """
    files = iter_py_files(paths)
    base = os.path.abspath(rel_to or os.getcwd())
    sources: List[tuple] = []
    for fpath in files:
        try:
            with open(fpath, "r", encoding="utf-8") as fh:
                sources.append((fpath, fh.read()))
        except (OSError, UnicodeDecodeError):
            continue
    found: List[Finding] = []
    sups: List[Suppression] = []
    for fpath, source in sources:
        rel = os.path.relpath(os.path.abspath(fpath), base)
        try:
            f, s = lint_source_detailed(source, path=rel, rules=rules)
            found.extend(f)
            sups.extend(s)
        except SyntaxError as e:
            found.append(Finding(
                rule="parse-error", severity="error", path=rel,
                line=e.lineno or 0, col=(e.offset or 0),
                message=f"file does not parse: {e.msg}"))
    found.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    sups.sort(key=lambda s: (s.path, s.line))
    return found, sups


def lint_paths(paths: Sequence[str], rules=None,
               rel_to: Optional[str] = None) -> List[Finding]:
    """Lint every ``.py`` under ``paths``; paths in findings are made
    relative to ``rel_to`` (default: cwd) so baselines are machine-portable.
    Pure-AST: nothing is imported or executed.
    """
    return lint_paths_detailed(paths, rules=rules, rel_to=rel_to)[0]
