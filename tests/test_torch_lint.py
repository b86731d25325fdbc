"""The port's lint tool (``gaussiank_sgd_torch/lint``) against the
reference's (``gaussiank_sgd_tpu/lint``).

* Parity: both tools give the same findings, as (rule, path, line, col),
  on ``tests/fixtures/gklint/`` (the concurrency and event-contract
  fixtures, and the four ported AST rules over the whole directory) and
  on inline snippets for each of them: the same source for
  ``fail-loud``, ``print-in-library``, ``lock-discipline`` and
  ``collective-outside-pipeline`` (``all_gather`` and
  ``butterfly_rounds`` are in both vocabularies).
* The reference's rules that read JAX's staging, ``host-sync-in-hot-path``
  among them, are not in the port's registry.
* The port's own vocabulary: torch's payload collectives and the port's
  funnels.
* Hygiene: a suppression without a ``-- justification`` exits 2, on both
  tiers; the baseline round-trips.

Pure AST: nothing here initializes jax or touches a device.
"""

import json
import os
import textwrap

import pytest

from gaussiank_sgd_tpu.lint import RULES_BY_NAME as REF_RULES
from gaussiank_sgd_tpu.lint import lint_paths as ref_lint_paths
from gaussiank_sgd_tpu.lint import lint_source as ref_lint_source
from gaussiank_sgd_tpu.lint.concurrency import \
    lint_concurrency as ref_lint_concurrency
from gaussiank_sgd_tpu.lint.event_contract import \
    run_events_check as ref_run_events_check
from gaussiank_sgd_torch.lint import (RULES_BY_NAME, default_baseline_path,
                                      lint_paths, lint_source, load_baseline,
                                      select_rules, split_new, write_baseline)
from gaussiank_sgd_torch.lint.__main__ import main
from gaussiank_sgd_torch.lint.concurrency import lint_concurrency
from gaussiank_sgd_torch.lint.event_contract import run_events_check

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "gklint")
PORTED = ("fail-loud", "print-in-library", "collective-outside-pipeline",
          "lock-discipline")
#: the reference's rules on JAX's staging, which the port does not carry
JAX_ONLY = ("host-sync-in-hot-path", "recompile-hazard",
            "mesh-axis-consistency", "donation-check", "traced-control-flow")


def keys(findings):
    return [(f.rule, f.path, f.line, f.col) for f in findings]


def both(src, rule, path="fixture.py", port_src=None):
    """(reference's findings, port's findings) of one snippet under one
    rule; ``port_src`` is the port's translation where the vocabulary
    differs."""
    ref = ref_lint_source(textwrap.dedent(src), path=path,
                          rules=[REF_RULES[rule]], known_axes=set())
    port = lint_source(textwrap.dedent(port_src or src), path=path,
                       rules=[RULES_BY_NAME[rule]])
    return keys(ref), keys(port)


def test_the_four_rules_keep_the_reference_names_and_severities():
    assert sorted(RULES_BY_NAME) == sorted(PORTED)
    assert sorted(REF_RULES) == sorted(PORTED + JAX_ONLY)
    for name in PORTED:
        assert RULES_BY_NAME[name].severity == REF_RULES[name].severity


@pytest.mark.parametrize("name", JAX_ONLY)
def test_a_jax_only_rule_is_refused_by_name(name, capsys):
    """The reference's staging rules are not carried: selecting one is an
    error naming the port's rules, from the library and the CLI."""
    with pytest.raises(KeyError, match="available: "
                       + ", ".join(sorted(PORTED))):
        select_rules([name])
    assert main(["--rules", name, FIXTURES]) == 2
    assert f"unknown rule(s): {name}" in capsys.readouterr().err


# ------------------------------------------------------ snippet parity

SHARED = [
    ("fail-loud", "fixture.py", """
        def f(x):
            assert x > 0, "positive"
            try:
                return 1 / x
            except:
                return 0
        """),
    ("fail-loud", "fixture.py", """
        def f(x):
            if x <= 0:
                raise ValueError("positive required")
            try:
                return 1 / x
            except ZeroDivisionError:
                return 0
        """),
    ("fail-loud", "fixture.py", """
        def f(x):
            assert x > 0  # gklint: disable=fail-loud -- a test
            # gklint: disable=fail-loud -- standalone
            assert x < 9
            assert x != 4
        """),
    ("print-in-library", "lib.py", """
        def report(x):
            print(x)

        if __name__ == "__main__":
            print("script mode")
        """),
    ("print-in-library", "__main__.py", """
        def report(x):
            print(x)
        """),
    ("collective-outside-pipeline", "parallel/fixture.py", """
        from jax import lax

        def rogue_exchange(x, axis):
            return lax.all_gather(x, axis, tiled=True)

        def butterfly_rounds(idx, axis):
            def swap(v):
                return lax.all_gather(v, axis)
            return swap(idx)
        """),
    ("collective-outside-pipeline", "models/fixture.py", """
        def anywhere(x, dist):
            return dist.all_gather(x)
        """),
    ("lock-discipline", "telemetry/fixture.py", """
        import threading

        class Meter:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def add(self):
                with self._lock:
                    self._n += 1

            def peek(self):
                return self._n

            def _bump_locked(self):
                self._n += 2
        """),
    ("lock-discipline", "models/fixture.py", """
        import threading

        class Meter:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def add(self):
                with self._lock:
                    self._n += 1

            def peek(self):
                return self._n
        """),
]


@pytest.mark.parametrize("rule,path,src", SHARED,
                         ids=[f"{r}-{i}" for i, (r, _, _) in
                              enumerate(SHARED)])
def test_shared_snippets_give_the_reference_findings(rule, path, src):
    ref, port = both(src, rule, path)
    assert port == ref


# ------------------------------------------------------ fixture parity

def test_ast_rules_on_the_fixture_dir_match_the_reference():
    ref = ref_lint_paths([FIXTURES], rules=[REF_RULES[r] for r in PORTED],
                         known_axes=set(), rel_to=FIXTURES)
    port = lint_paths([FIXTURES], rules=[RULES_BY_NAME[r] for r in PORTED],
                      rel_to=FIXTURES)
    assert keys(port) == keys(ref)


def test_concurrency_fixtures_match_the_reference():
    ref, ref_sups = ref_lint_concurrency([FIXTURES], rel_to=FIXTURES)
    port, sups = lint_concurrency([FIXTURES], rel_to=FIXTURES)
    assert keys(port) == keys(ref)
    assert {f.rule for f in port} == {
        "conc-unguarded-access", "conc-callback-under-lock",
        "conc-thread-escape", "conc-blocking-under-lock"}
    assert [(s.line, s.justification) for s in sups] \
        == [(s.line, s.justification) for s in ref_sups]


@pytest.mark.parametrize("sites", ["events_sites_bad.py",
                                   "events_sites_clean.py"])
def test_event_contract_fixtures_match_the_reference(sites, tmp_path):
    kw = dict(paths=[os.path.join(FIXTURES, sites)],
              events_py=os.path.join(FIXTURES, "events_catalog.py"),
              write=True, rel_to=FIXTURES)
    ref, ref_sites, ref_snap = ref_run_events_check(
        snap_path=str(tmp_path / "ref.json"), **kw)
    port, port_sites, snap = run_events_check(
        snap_path=str(tmp_path / "port.json"), **kw)
    assert keys(port) == keys(ref)
    assert [s.to_json() for s in port_sites] \
        == [s.to_json() for s in ref_sites]
    assert snap == ref_snap


# ------------------------------------------------- the port's vocabulary

def test_torch_collectives_outside_the_funnels_are_flagged():
    found = lint_source(textwrap.dedent("""
        import torch.distributed as dist

        def rogue(x, out, peer):
            dist.all_gather_into_tensor(out, x)
            return dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, peer)])

        def raw(x, peer):
            dist.isend(x, peer)
            dist.irecv(x, peer)

        class Step:
            def _pipelined_phase(self, x, out):
                dist.all_gather_into_tensor(out, x)

            def _launch(self, x, out):
                return dist.all_gather_into_tensor(out, x, async_op=True)

        def _rotate(ops):
            return dist.batch_isend_irecv(ops)
        """), path="parallel/fixture.py",
        rules=[RULES_BY_NAME["collective-outside-pipeline"]])
    assert [(f.line, f.message.split("(")[0]) for f in found] == [
        (5, "payload collective all_gather_into_tensor"),
        (6, "payload collective batch_isend_irecv"),
        (10, "payload collective isend"),
        (11, "payload collective irecv")]


# ---------------------------------------------------------------- hygiene

def test_a_suppression_without_justification_exits_2(tmp_path, capsys):
    lib = tmp_path / "lib.py"
    lib.write_text("def f(x):\n    assert x  # gklint: disable=fail-loud\n")
    assert main([str(lib)]) == 2
    assert "has no `-- justification`" in capsys.readouterr().out
    lib.write_text("def f(x):\n    assert x  # gklint: disable=fail-loud "
                   "-- an internal invariant\n")
    assert main([str(lib)]) == 0
    exp = tmp_path / "telemetry" / "exp.py"
    exp.parent.mkdir()
    exp.write_text(textwrap.dedent("""
        import threading

        class E:
            def __init__(self):
                self._lock = threading.Lock()

            def write(self, f):
                with self._lock:
                    f.write("x")  # gklint: disable=conc-blocking-under-lock
        """))
    assert main(["concurrency", str(exp)]) == 2


def test_baseline_roundtrips_and_gates_only_new_findings(tmp_path, capsys):
    src = "def f(x):\n    assert x > 0\n"
    lib = tmp_path / "lib.py"
    lib.write_text(src)
    found = lint_paths([str(lib)], rel_to=str(tmp_path))
    assert len(found) == 1
    path = tmp_path / "baseline.json"
    write_baseline(str(path), found)
    base = load_baseline(str(path))
    assert base == {found[0].fingerprint: 1}
    assert json.loads(path.read_text())["version"] == 1
    new, old = split_new(found, base)
    assert (new, old) == ([], found)
    assert main([str(lib), "--baseline", str(path)]) == 0
    capsys.readouterr()
    lib.write_text(src + "def g(y):\n    assert y\n")
    assert main([str(lib), "--baseline", str(path), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["counts"] == {"total": 2, "new": 1, "baselined": 1}
    assert os.path.basename(default_baseline_path()) \
        == ".gklint-torch-baseline.json"
