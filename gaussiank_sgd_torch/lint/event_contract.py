"""gklint v3 — event-contract cross-checker (`lint events`; port of
``gaussiank_sgd_tpu/lint/event_contract.py``).

The port's ``telemetry/events.py`` catalogs every event kind its runtime
may put on the bus (``EVENT_SCHEMAS``); ``validate_record`` enforces it at
runtime. This tier closes the loop *statically*: it resolves every
``publish(`` / ``.emit(`` site in the port's package (its bench,
matrix and sentinel are inside it) to its event ``kind`` and literal
payload keys, then cross-checks against the catalog:

* ``event-uncataloged-kind`` — a site publishes a kind the catalog does
  not know;
* ``event-never-published`` — a cataloged kind with no publish site
  anywhere (dead schema);
* ``event-dead-field`` — a schema field set at no publish site, for
  kinds whose sites are all *closed* (fully literal payloads);
* ``event-unknown-field`` — a literal payload key the schema does not
  declare (extras are legal at runtime; a literal one is a typo);
* ``event-missing-required`` — a closed site that omits a required
  field.

Site resolution is pure-AST. A site is **closed** when every payload key
is a string literal (dict literal keys, ``rec["k"] = ...`` subscripts,
``rec.update({...literal...})``, keyword args to ``.emit``); ``**expr``
or ``rec.update(dynamic)`` makes it **open** — its literal keys still
count, but absence proves nothing. Kinds flow through one level of
parameter indirection (``self._publish(event, payload)`` resolves via
the intra-module call sites of the enclosing function), which is how the
policy engine's ``policy_decision`` / ``policy_revert`` sites resolve.

The result is ratcheted in a committed ``.gklint-torch-events.json``
(beside the reference's ``.gklint-events.json``, whose kinds differ by
the stated standing differences of the port's stream): kind set,
required/optional fields and the observed site-field union must match,
or the run fails with ``event-drift`` until re-baselined via
``--write-events``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, iter_py_files

EVENTS_VERSION = 1
DEFAULT_EVENTS_BASENAME = ".gklint-torch-events.json"

# fields stamped by the bus envelope, never set at publish sites
_ENVELOPE = {"schema_version", "seq", "ts", "event"}

_PUBLISH_NAMES = {"publish", "_publish"}


def default_events_path() -> str:
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg_dir), DEFAULT_EVENTS_BASENAME)


def default_scan_paths() -> List[str]:
    """The port's package: its emitters are all inside it."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


# --------------------------------------------------------------------------
# catalog (EVENT_SCHEMAS parsed from the events.py AST — never imported)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KindSchema:
    kind: str
    line: int
    required: Dict[str, str]  # field -> type label (NUMBER/STRING/...)
    optional: Dict[str, str]

    @property
    def fields(self) -> Set[str]:
        return set(self.required) | set(self.optional)


def load_catalog(events_path: str) -> Tuple[Dict[str, KindSchema], str]:
    """Parse ``EVENT_SCHEMAS`` out of events.py. Returns (catalog, error);
    ``error`` is non-empty when the dict cannot be located/parsed."""
    try:
        with open(events_path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=events_path)
    except (OSError, SyntaxError) as e:
        return {}, f"cannot parse {events_path}: {e}"
    schemas: Dict[str, KindSchema] = {}
    for node in tree.body:
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        if not (targets
                and any(isinstance(t, ast.Name) and t.id == "EVENT_SCHEMAS"
                        for t in targets)
                and isinstance(getattr(node, "value", None), ast.Dict)):
            continue
        for key, val in zip(node.value.keys, node.value.values):
            if not (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)):
                continue
            req, opt = _parse_schema_call(val)
            schemas[key.value] = KindSchema(
                kind=key.value, line=key.lineno, required=req, optional=opt)
    if not schemas:
        return {}, f"no EVENT_SCHEMAS dict found in {events_path}"
    return schemas, ""


def _parse_schema_call(val: ast.AST) -> Tuple[Dict[str, str], Dict[str, str]]:
    req: Dict[str, str] = {}
    opt: Dict[str, str] = {}
    if not isinstance(val, ast.Call):
        return req, opt
    args = {i: a for i, a in enumerate(val.args)}
    kwargs = {kw.arg: kw.value for kw in val.keywords if kw.arg}
    req_node = kwargs.get("required", args.get(0))
    opt_node = kwargs.get("optional", args.get(1))
    for node, out in ((req_node, req), (opt_node, opt)):
        if not isinstance(node, ast.Dict):
            continue
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                out[k.value] = _type_label(v)
    return req, opt


def _type_label(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return "?"


# --------------------------------------------------------------------------
# publish-site scanner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PublishSite:
    path: str
    line: int
    kind: Optional[str]  # None = dynamic (kind not a resolvable literal)
    keys: Set[str]
    open: bool  # True when non-literal keys may be added at runtime
    via: str    # short description of the site shape (for messages/json)

    def to_json(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "kind": self.kind,
                "keys": sorted(self.keys), "open": self.open,
                "via": self.via}


class _ModuleScanner:
    """All publish sites of one module."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.parent: Dict[ast.AST, ast.AST] = {}
        for p in ast.walk(tree):
            for c in ast.iter_child_nodes(p):
                self.parent[c] = p
        self.sites: List[PublishSite] = []
        # dict literals consumed by a site pattern, so the standalone
        # dict-literal sweep doesn't register them twice
        self._claimed: Set[int] = set()

    # -- the scan ----------------------------------------------------------
    def scan(self) -> List[PublishSite]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._scan_call(node)
        # any remaining dict literal with a literal "event" key is a
        # payload construction (e.g. health.tick builds and returns the
        # record; the trainer publishes it cross-module)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Dict) and id(node) not in self._claimed:
                self._scan_payload_dict(node)
        return self.sites

    # -- helpers -----------------------------------------------------------
    def _enclosing_fn(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parent.get(cur)
        return None

    def _add(self, node: ast.AST, kind: Optional[str], keys: Set[str],
             open_: bool, via: str) -> None:
        self.sites.append(PublishSite(
            path=self.path, line=getattr(node, "lineno", 0), kind=kind,
            keys={k for k in keys if k not in _ENVELOPE}, open=open_,
            via=via))

    # -- call patterns -----------------------------------------------------
    def _scan_call(self, call: ast.Call) -> None:
        term = ""
        if isinstance(call.func, ast.Attribute):
            term = call.func.attr
        elif isinstance(call.func, ast.Name):
            term = call.func.id

        # exporter-style ingest — Exporter.emit(record) / engine.emit(rec) /
        # mon.emit(rec): a dict fed INTO a consumer, not a publish site
        if term == "emit" and len(call.args) == 1 \
                and isinstance(call.args[0], ast.Dict):
            self._claimed.add(id(call.args[0]))
            return

        # bus.emit("kind", k=v, ..., **rest)
        if term == "emit" and call.args \
                and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            keys: Set[str] = set()
            open_ = len(call.args) > 1
            for kw in call.keywords:
                if kw.arg is not None:
                    keys.add(kw.arg)
                else:
                    k2, o2 = self._resolve_dict_expr(call, kw.value)
                    keys |= k2
                    open_ = open_ or o2
            self._add(call, call.args[0].value, keys, open_, "emit")
            return

        # publish(kind, payload) / self._publish(event, payload):
        # two-arg form with a string-ish kind expression
        if term in _PUBLISH_NAMES and len(call.args) == 2:
            kind_expr, payload = call.args
            kinds = self._resolve_kind_expr(call, kind_expr)
            keys, open_ = self._resolve_dict_expr(call, payload)
            if kinds:
                for k in kinds:
                    self._add(call, k, keys, open_, "publish-indirect")
            else:
                self._add(call, None, keys, open_, "publish-dynamic")
            return

    def _scan_payload_dict(self, node: ast.Dict) -> None:
        keys, open_, kind = self._dict_literal_keys(node)
        if "event" not in keys:
            return
        var = self._assigned_var(node)
        if var is not None:
            fn = self._enclosing_fn(node)
            if fn is not None:
                k2, o2, kind2 = self._augment_from_var(fn, node, var)
                keys |= k2
                open_ = open_ or o2
                kind = kind or kind2
        self._add(node, kind, keys, open_,
                  "payload-dict" if kind else "payload-dict-dynamic")

    # -- expression resolution --------------------------------------------
    def _resolve_kind_expr(self, call: ast.Call,
                           expr: ast.AST) -> List[str]:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return [expr.value]
        if isinstance(expr, ast.Name):
            fn = self._enclosing_fn(call)
            if fn is not None and not isinstance(fn, ast.Lambda):
                return self._backprop_param(fn, expr.id)
        return []

    def _backprop_param(self, fn: ast.AST, param: str) -> List[str]:
        """Literal values flowing into ``param`` of ``fn`` from intra-module
        call sites of ``fn`` — one level deep, enough for the
        ``_log(..., "policy_decision", ...) -> self._publish(event, ...)``
        pattern."""
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        if param not in params:
            return []
        idx = params.index(param)
        offset = 1 if params and params[0] in ("self", "cls") else 0
        kinds: List[str] = []
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func
            name = callee.attr if isinstance(callee, ast.Attribute) else (
                callee.id if isinstance(callee, ast.Name) else "")
            if name != fn.name:
                continue
            arg: Optional[ast.AST] = None
            pos = idx - offset
            if 0 <= pos < len(node.args):
                arg = node.args[pos]
            for kw in node.keywords:
                if kw.arg == param:
                    arg = kw.value
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                kinds.append(arg.value)
        return sorted(set(kinds))

    def _resolve_dict_expr(self, call: ast.Call,
                           expr: ast.AST) -> Tuple[Set[str], bool]:
        """(literal keys, open) for a payload expression at a call site."""
        if isinstance(expr, ast.Dict):
            keys, open_, _ = self._dict_literal_keys(expr)
            self._claimed.add(id(expr))
            var = self._assigned_var(expr)
            if var is not None:
                fn = self._enclosing_fn(expr)
                if fn is not None:
                    k2, o2, _ = self._augment_from_var(fn, expr, var)
                    keys |= k2
                    open_ = open_ or o2
            return keys, open_
        if isinstance(expr, ast.Name):
            fn = self._enclosing_fn(call)
            if fn is None:
                return set(), True
            src = self._find_dict_assign(fn, expr.id)
            if src is None:
                return set(), True
            keys, open_, _ = self._dict_literal_keys(src)
            self._claimed.add(id(src))
            k2, o2, _ = self._augment_from_var(fn, src, expr.id)
            return keys | k2, open_ or o2
        return set(), True

    def _dict_literal_keys(self, node: ast.Dict) -> Tuple[Set[str], bool,
                                                          Optional[str]]:
        """(keys, open, event-kind) of one dict literal. ``**expr``
        spreads resolve one level through a local dict variable."""
        keys: Set[str] = set()
        open_ = False
        kind: Optional[str] = None
        for k, v in zip(node.keys, node.values):
            if k is None:  # **expr
                if isinstance(v, ast.Name):
                    fn = self._enclosing_fn(node)
                    src = self._find_dict_assign(fn, v.id) if fn else None
                    if src is not None and src is not node:
                        k2, o2, _ = self._dict_literal_keys(src)
                        k3, o3, _ = self._augment_from_var(fn, src, v.id)
                        keys |= k2 | k3
                        open_ = open_ or o2 or o3
                        self._claimed.add(id(src))
                        continue
                open_ = True
                continue
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.add(k.value)
                if k.value == "event":
                    if isinstance(v, ast.Constant) \
                            and isinstance(v.value, str):
                        kind = v.value
            else:
                open_ = True  # computed key (dict comprehensions etc.)
        return keys, open_, kind

    def _assigned_var(self, node: ast.Dict) -> Optional[str]:
        p = self.parent.get(node)
        if isinstance(p, ast.Assign) and len(p.targets) == 1 \
                and isinstance(p.targets[0], ast.Name):
            return p.targets[0].id
        if isinstance(p, ast.AnnAssign) and isinstance(p.target, ast.Name):
            return p.target.id
        return None

    def _find_dict_assign(self, fn: ast.AST,
                          name: str) -> Optional[ast.Dict]:
        found: Optional[ast.Dict] = None
        for node in ast.walk(fn):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            if targets and isinstance(getattr(node, "value", None),
                                      ast.Dict) \
                    and any(isinstance(t, ast.Name) and t.id == name
                            for t in targets):
                found = found or node.value
        return found

    def _augment_from_var(self, fn: ast.AST, src: ast.Dict,
                          name: str) -> Tuple[Set[str], bool, Optional[str]]:
        """Keys added to dict variable ``name`` after construction:
        ``name["k"] = ...``, ``name.update({...})``, ``name.setdefault``."""
        keys: Set[str] = set()
        open_ = False
        kind: Optional[str] = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == name:
                        if isinstance(t.slice, ast.Constant) \
                                and isinstance(t.slice.value, str):
                            keys.add(t.slice.value)
                            if t.slice.value == "event" and \
                                    isinstance(node.value, ast.Constant) \
                                    and isinstance(node.value.value, str):
                                kind = node.value.value
                        else:
                            open_ = True
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == name:
                if node.func.attr == "update":
                    if node.args and isinstance(node.args[0], ast.Dict):
                        k2, o2, _ = self._dict_literal_keys(node.args[0])
                        keys |= k2
                        open_ = open_ or o2
                    elif node.args:
                        open_ = True
                    keys |= {kw.arg for kw in node.keywords if kw.arg}
                    open_ = open_ or any(kw.arg is None
                                         for kw in node.keywords)
                elif node.func.attr == "setdefault" and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    keys.add(node.args[0].value)
        return keys, open_, kind


def scan_sites(paths: Sequence[str],
               rel_to: Optional[str] = None) -> List[PublishSite]:
    base = os.path.abspath(rel_to or os.getcwd())
    sites: List[PublishSite] = []
    for fpath in iter_py_files(paths):
        try:
            with open(fpath, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=fpath)
        except (OSError, UnicodeDecodeError, SyntaxError):
            continue
        rel = os.path.relpath(os.path.abspath(fpath), base)
        sites.extend(_ModuleScanner(rel, tree).scan())
    sites.sort(key=lambda s: (s.path, s.line))
    return sites


# --------------------------------------------------------------------------
# cross-checks
# --------------------------------------------------------------------------

def check_contract(catalog: Dict[str, KindSchema],
                   sites: Sequence[PublishSite],
                   events_path: str,
                   rel_to: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    by_kind: Dict[str, List[PublishSite]] = {}
    for s in sites:
        if s.kind is not None:
            by_kind.setdefault(s.kind, []).append(s)

    for kind, ksites in sorted(by_kind.items()):
        schema = catalog.get(kind)
        if schema is None:
            for s in ksites:
                findings.append(Finding(
                    rule="event-uncataloged-kind", severity="error",
                    path=s.path, line=s.line, col=1,
                    message=f'event kind "{kind}" is published here but '
                            f'not cataloged in EVENT_SCHEMAS '
                            f'({os.path.basename(events_path)})'))
            continue
        for s in ksites:
            unknown = s.keys - schema.fields - _ENVELOPE
            for fld in sorted(unknown):
                findings.append(Finding(
                    rule="event-unknown-field", severity="error",
                    path=s.path, line=s.line, col=1,
                    message=f'"{kind}" site sets literal field "{fld}" '
                            f'that EVENT_SCHEMAS does not declare '
                            f'(typo or schema rot)'))
            if not s.open:
                missing = set(schema.required) - s.keys - _ENVELOPE
                for fld in sorted(missing):
                    findings.append(Finding(
                        rule="event-missing-required", severity="error",
                        path=s.path, line=s.line, col=1,
                        message=f'closed "{kind}" site omits required '
                                f'field "{fld}"'))

    rel_events = os.path.relpath(
        os.path.abspath(events_path),
        os.path.abspath(rel_to or os.getcwd()))
    for kind, schema in sorted(catalog.items()):
        ksites = by_kind.get(kind, [])
        if not ksites:
            findings.append(Finding(
                rule="event-never-published", severity="warning",
                path=rel_events, line=schema.line, col=1,
                message=f'event kind "{kind}" is cataloged but no publish '
                        f'site emits it — dead schema entry'))
            continue
        if all(not s.open for s in ksites):
            seen: Set[str] = set()
            for s in ksites:
                seen |= s.keys
            dead = schema.fields - seen - _ENVELOPE
            for fld in sorted(dead):
                findings.append(Finding(
                    rule="event-dead-field", severity="warning",
                    path=rel_events, line=schema.line, col=1,
                    message=f'"{kind}" field "{fld}" is set at none of '
                            f'the {len(ksites)} (all-closed) publish '
                            f'site(s) — dead schema field'))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# --------------------------------------------------------------------------
# ratchet (.gklint-torch-events.json)
# --------------------------------------------------------------------------

def snapshot(catalog: Dict[str, KindSchema],
             sites: Sequence[PublishSite]) -> Dict[str, object]:
    by_kind: Dict[str, List[PublishSite]] = {}
    dynamic = 0
    for s in sites:
        if s.kind is None:
            dynamic += 1
        else:
            by_kind.setdefault(s.kind, []).append(s)
    kinds: Dict[str, object] = {}
    for kind in sorted(set(catalog) | set(by_kind)):
        schema = catalog.get(kind)
        ksites = by_kind.get(kind, [])
        fields: Set[str] = set()
        for s in ksites:
            fields |= s.keys
        kinds[kind] = {
            "required": sorted(schema.required) if schema else [],
            "optional": sorted(schema.optional) if schema else [],
            "sites": len(ksites),
            "open_sites": sum(1 for s in ksites if s.open),
            "site_fields": sorted(fields - _ENVELOPE),
        }
    return {"version": EVENTS_VERSION, "tool": "gklint-events",
            "kinds": kinds, "dynamic_sites": dynamic}


def load_snapshot(path: str) -> Optional[Dict[str, object]]:
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != EVENTS_VERSION:
        raise ValueError(
            f"events snapshot {path} has version {data.get('version')!r}, "
            f"this gklint reads version {EVENTS_VERSION} — regenerate "
            f"with --write-events")
    return data


def write_snapshot(path: str, snap: Dict[str, object]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(snap, fh, indent=2, sort_keys=False)
        fh.write("\n")


def diff_snapshot(current: Dict[str, object],
                  committed: Dict[str, object],
                  snap_path: str,
                  rel_to: Optional[str] = None) -> List[Finding]:
    """Drift between the scan and the committed ratchet, as findings."""
    out: List[Finding] = []
    rel = os.path.relpath(os.path.abspath(snap_path),
                          os.path.abspath(rel_to or os.getcwd()))

    def drift(msg: str) -> None:
        out.append(Finding(rule="event-drift", severity="error", path=rel,
                           line=0, col=1,
                           message=msg + " — intended? re-baseline with "
                                         "`lint events --write-events`"))

    cur = dict(current.get("kinds", {}))  # type: ignore[arg-type]
    old = dict(committed.get("kinds", {}))  # type: ignore[arg-type]
    for kind in sorted(set(old) - set(cur)):
        drift(f'event kind "{kind}" disappeared from the catalog/sites')
    for kind in sorted(set(cur) - set(old)):
        drift(f'new event kind "{kind}" not in the committed snapshot')
    for kind in sorted(set(cur) & set(old)):
        c, o = cur[kind], old[kind]
        for field in ("required", "optional", "site_fields", "sites",
                      "open_sites"):
            if c.get(field) != o.get(field):
                drift(f'"{kind}" {field} changed: '
                      f'{o.get(field)!r} -> {c.get(field)!r}')
    if current.get("dynamic_sites") != committed.get("dynamic_sites"):
        drift(f'dynamic (unresolvable-kind) site count changed: '
              f'{committed.get("dynamic_sites")!r} -> '
              f'{current.get("dynamic_sites")!r}')
    return out


def run_events_check(paths: Optional[Sequence[str]] = None,
                     events_py: Optional[str] = None,
                     snap_path: Optional[str] = None,
                     write: bool = False,
                     rel_to: Optional[str] = None):
    """Full tier: scan, contract checks, ratchet. Returns
    ``(findings, sites, snapshot_dict)``."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    events_py = events_py or os.path.join(pkg_dir, "telemetry", "events.py")
    snap_path = snap_path or default_events_path()
    scan = list(paths) if paths else default_scan_paths()
    catalog, err = load_catalog(events_py)
    if err:
        return [Finding(rule="event-contract", severity="error",
                        path=events_py, line=0, col=1, message=err)], [], {}
    sites = scan_sites(scan, rel_to=rel_to)
    findings = check_contract(catalog, sites, events_py, rel_to=rel_to)
    snap = snapshot(catalog, sites)
    if write:
        write_snapshot(snap_path, snap)
    else:
        committed = load_snapshot(snap_path)
        if committed is None:
            findings.append(Finding(
                rule="event-drift", severity="error",
                path=os.path.relpath(
                    os.path.abspath(snap_path),
                    os.path.abspath(rel_to or os.getcwd())),
                line=0, col=1,
                message="no committed events snapshot — generate with "
                        "`lint events --write-events` and commit it"))
        else:
            findings.extend(diff_snapshot(snap, committed, snap_path,
                                          rel_to=rel_to))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, sites, snap
