"""gklint program tier for the port: the step audit (``lint audit``; the
torch counterpart of ``gaussiank_sgd_tpu/lint/program_audit.py``).

The reference traces its jitted step and reads the jaxpr. Nothing in the
port is traced, so this tier RUNS the step instead: for each arm of the
reference's matrix (the same 13 names and specs in :data:`ARMS`) it builds
the port's ``DPTrainStep`` (``parallel/trainstep.py``) on the reference's
tiny two-layer MLP, seeded, runs a first step and then two warm steps, and
checks:

* **(a) host syncs** — on a CUDA device, every device-to-host sync of a
  warm step is caught under ``torch.cuda.set_sync_debug_mode`` and
  attributed to the port's function that made it. Each must be a site of
  :data:`SYNC_ALLOWED` named in the arm's allow-list
  (:func:`allowed_syncs`), at most its stated count a step, and each
  allowed site is there with its reason. Run it in a process group of one
  NCCL rank (:func:`run_audit` forms one): gloo stages CUDA tensors
  through the host, which would hide the count. On the CPU there is no
  device to wait for: the audit says so and skips the contract; it does
  not pass it.
* **(b) the collective inventory** — every call through
  ``parallel/collectives.py`` (outermost calls only), each marked whether
  the pipelined phase (``DPTrainStep._pipelined_phase``) is on the stack.
  A pipelined build issues at least one payload collective a chunk inside
  it; a sequential build issues none there and one a payload tensor of the
  whole plan (the buckets' pairs go in one gather a tensor, as the
  reference's ``_gather``), gtopk log2(P) hops; ``dense_reference``
  issues only the all-reduce (no payload collective).
* **(c) the reference's two identities** — ``wire-ineligible-equals-legacy``
  and ``overlap-ineligible-equals-off``: the paired arms resolve the same
  ``wire_format`` and ``overlap``, and reach states (parameters, optimizer
  state, EF row, thresholds) that are bit for bit equal after the steps.

The per-arm inventory is committed to ``.gklint-torch-programs.json`` as
the ratchet, in place of the reference's jaxpr fingerprints; drift gates
until re-baselined with ``--write-programs``. The fingerprints and the
donation contract have no torch counterpart (nothing is traced; the port
updates in place).

At a world of one the gTop-k pipelined arm builds sequential: its gate
needs a round-1 partner (``mesh.sizes[-1] >= 2``), as the reference's
does; :func:`expected` applies that gate to the arm's expectation.

Usage::

    python -m gaussiank_sgd_torch.lint audit                 # the card
    python -m gaussiank_sgd_torch.lint audit --device cpu    # no syncs
    python -m gaussiank_sgd_torch.lint audit --list-arms
    python -m gaussiank_sgd_torch.lint audit --arms a,b -o audit.json
    python -m gaussiank_sgd_torch.lint audit --write-programs

Exit codes: 0 all contracts hold, 1 violation/drift, 2 usage error.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import json
import math
import os
import sys
import tempfile
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

PROGRAMS_VERSION = 1

#: collectives.py functions that move a gradient payload
PAYLOAD_COLLECTIVES = ("all_gather", "all_gather_async", "exchange_with",
                       "exchange_with_async", "sparse_allgather_sum",
                       "hierarchical_sparse_allgather_sum")
#: collectives.py functions that reduce (the dense exchange, the means)
REDUCTIONS = ("all_reduce_sum", "pmean", "dense_allreduce")

_PIPELINE_FRAME = "_pipelined_phase"

# ---------------------------------------------------------------------------
# the config matrix: the reference's, name for name
# ---------------------------------------------------------------------------
# Every arm is a tiny two-layer MLP on the process group's workers.
# `expect` pins what the build must report; `identity` groups arms whose
# sparse steps must commit the same bits.

ARMS: Dict[str, Dict[str, Any]] = {
    "allgather_seq_legacy": dict(
        selector="topk", exchange="allgather", wire="off", overlap="off",
        expect=dict(wire_format="i32f32", overlap="off")),
    "allgather_seq_wire": dict(
        selector="topk", exchange="allgather", wire="auto", overlap="off",
        expect=dict(wire_format="u16bf16", overlap="off")),
    "allgather_pipe_legacy": dict(
        selector="topk", exchange="allgather", wire="off", overlap="auto",
        expect=dict(wire_format="i32f32", overlap="pipelined")),
    "allgather_pipe_wire": dict(
        selector="topk", exchange="allgather", wire="auto", overlap="auto",
        expect=dict(wire_format="u16bf16", overlap="pipelined")),
    "gtopk_seq_legacy": dict(
        selector="topk", exchange="gtopk", wire="off", overlap="off",
        expect=dict(wire_format="i32f32", overlap="off")),
    "gtopk_pipe_wire": dict(
        selector="topk", exchange="gtopk", wire="auto", overlap="auto",
        expect=dict(wire_format="u16bf16", overlap="pipelined")),
    "randomk_pipe_wire": dict(
        selector="randomk", exchange="allgather", wire="auto",
        overlap="auto",
        expect=dict(wire_format="u16bf16", overlap="pipelined")),
    "gaussian_fused_pipe_wire": dict(
        selector="gaussian_fused", exchange="allgather", wire="auto",
        overlap="auto", din=64, width=256, bucket_size=128, density=0.0625,
        expect=dict(wire_format="u16bf16", overlap="pipelined")),
    # wire=auto on a boundary-respecting (non-uniform) plan is INELIGIBLE
    # and must commit the bits of the legacy build
    "greedy_wire_auto_ineligible": dict(
        selector="topk", exchange="allgather", wire="auto", overlap="off",
        policy="greedy",
        expect=dict(wire_format="i32f32", overlap="off"),
        identity="wire-ineligible-equals-legacy"),
    "greedy_wire_off_legacy": dict(
        selector="topk", exchange="allgather", wire="off", overlap="off",
        policy="greedy",
        expect=dict(wire_format="i32f32", overlap="off"),
        identity="wire-ineligible-equals-legacy"),
    # overlap=auto on a single-bucket plan is INELIGIBLE (nothing to
    # pipeline against) and must commit the bits of the sequential build
    "singlebucket_overlap_auto_ineligible": dict(
        selector="topk", exchange="allgather", wire="off", overlap="auto",
        bucket_size=4096,
        expect=dict(wire_format="i32f32", overlap="off"),
        identity="overlap-ineligible-equals-off"),
    "singlebucket_overlap_off": dict(
        selector="topk", exchange="allgather", wire="off", overlap="off",
        bucket_size=4096,
        expect=dict(wire_format="i32f32", overlap="off"),
        identity="overlap-ineligible-equals-off"),
    # the dense twin every parity claim compares against: all-reduce only,
    # no payload collectives at all
    "dense_reference": dict(
        selector="topk", exchange="allgather", wire="off", overlap="off",
        dense=True,
        expect=dict(wire_format="i32f32", overlap="off")),
}

# ---------------------------------------------------------------------------
# (a) the host syncs a warm step may make on the card
# ---------------------------------------------------------------------------
#: ``path:function`` of the port -> (most a compressor call may make, the
#: reason). A batched compressor call covers every bucket of the
#: sequential step and one chunk of the pipelined one.
SYNC_ALLOWED: Dict[str, Tuple[int, str]] = {
    "gaussiank_sgd_torch/compressors/gaussian.py:"
    "gaussian_warm_compress_batched": (
        1, "the warm compressors' host predicate, `bool(usable.all())`: "
           "the reference's lax.cond is a branch on the device; the port "
           "reads the predicate on the host once a call (a stated "
           "standing difference). gaussian_fused above B1's density 1/32 "
           "is this warm fallback"),
}

#: arm -> the sites of SYNC_ALLOWED its warm step may reach (every other
#: arm's warm step makes no host sync)
ARM_SYNCS: Dict[str, Tuple[str, ...]] = {
    "gaussian_fused_pipe_wire": (
        "gaussiank_sgd_torch/compressors/gaussian.py:"
        "gaussian_warm_compress_batched",),
}


def allowed_syncs(arm: str, calls: int = 1) -> Dict[str, Tuple[int, str]]:
    """The arm's allow-list at ``calls`` compressor calls a step (the
    chunks of a pipelined build, else 1): ``{site: (most a warm step,
    reason)}``."""
    return {site: (SYNC_ALLOWED[site][0] * calls, SYNC_ALLOWED[site][1])
            for site in ARM_SYNCS.get(arm, ())}


def expected(spec: Dict[str, Any], world: int) -> Dict[str, str]:
    """The arm's ``expect`` at a world of ``world``: the reference's,
    whose mesh has 2 devices, with its own gate applied — gtopk pipelines
    only with a round-1 partner."""
    exp = dict(spec.get("expect", {}))
    if spec.get("exchange") == "gtopk" and world < 2:
        exp["overlap"] = "off"
    return exp


def default_programs_path() -> str:
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, ".gklint-torch-programs.json")


# ---------------------------------------------------------------------------
# (b) counting the calls through parallel/collectives.py
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_collectives():
    """While active, every outermost call of a collective of
    ``parallel/collectives.py`` — through the module or through a name
    another module of the package imported from it — is appended to the
    yielded list as ``(name, in_pipeline)``."""
    from ..parallel import collectives
    names = PAYLOAD_COLLECTIVES + REDUCTIONS
    real = {n: getattr(collectives, n) for n in names}
    calls: List[Tuple[str, bool]] = []
    depth = [0]

    def wrap(name, fn):
        def counted(*args, **kw):
            if depth[0] == 0:
                calls.append((name, _in_pipeline()))
            depth[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
        return counted

    wrappers = {id(fn): wrap(n, fn) for n, fn in real.items()}
    patched = []
    for modname, mod in list(sys.modules.items()):
        if mod is None or not modname.startswith(
                __name__.split(".")[0] + "."):
            continue
        for attr, val in list(vars(mod).items()):
            if any(val is fn for fn in real.values()):
                patched.append((mod, attr, val))
                setattr(mod, attr, wrappers[id(val)])
    try:
        yield calls
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


def _in_pipeline() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == _PIPELINE_FRAME:
            return True
        f = f.f_back
    return False


def inventory(calls: Sequence[Tuple[str, bool]], steps: int
              ) -> Dict[str, Dict[str, float]]:
    """``{name: {"total", "in_pipeline"}}``, a step's mean over ``steps``."""
    inv: Dict[str, Dict[str, float]] = {}
    for name, inside in calls:
        ent = inv.setdefault(name, {"total": 0, "in_pipeline": 0})
        ent["total"] += 1
        ent["in_pipeline"] += int(inside)
    return {n: {k: v / steps for k, v in e.items()}
            for n, e in sorted(inv.items())}


# ---------------------------------------------------------------------------
# (a) catching the syncs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _function_spans(path: str) -> Tuple[Tuple[int, int, str], ...]:
    """``(first line, last line, name)`` of every function of ``path``,
    the innermost (shortest) first."""
    try:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return ()
    spans = [(node.lineno, node.end_lineno or 0, node.name)
             for node in ast.walk(tree)
             if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]
    return tuple(sorted(spans, key=lambda s: s[1] - s[0]))


def _function_at(path: str, line: int) -> str:
    """The innermost function of ``path`` whose body holds ``line``."""
    for lo, hi, name in _function_spans(path):
        if lo <= line <= hi:
            return name
    return "<module>"


def _site(filename: str, line: int) -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.abspath(filename)
    rel = os.path.relpath(path, repo) if path.startswith(repo) else path
    return f"{rel}:{_function_at(path, line)}"


@contextlib.contextmanager
def caught_syncs():
    """While active on a CUDA device, every synchronizing CUDA operation
    is appended to the yielded list as its ``path:function`` site (the
    Python frame that made it). The debug mode is switched on and off
    outside the recording: the switch itself is no step's sync."""
    import torch
    sites: List[str] = []
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield sites
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode(prev)
    sites.extend(_site(w.filename, w.lineno) for w in caught
                 if "synchroniz" in str(w.message))


# ---------------------------------------------------------------------------
# running one arm
# ---------------------------------------------------------------------------

WARM_STEPS = 2


def build_arm(spec: Dict[str, Any], device, seed: int = 0):
    """``(step, batch)``: the arm's ``DPTrainStep`` on the reference's MLP
    (``din`` -> ``width`` tanh -> 4), its flat parameter in the reference's
    ravel order (b1, b2, w1, w2) drawn from ``seed``, and a batch of 8
    rows a worker."""
    import torch
    from ..compressors import get_compressor
    from ..parallel.bucketing import plan_for_params
    from ..parallel.flat_opt import OptaxSGD
    from ..parallel.trainstep import DPTrainStep, flat_numel

    din = spec.get("din", 16)
    width = spec.get("width", 32)
    dout = 4
    density = spec.get("density", 0.25)
    layout = [("b1", (width,)), ("b2", (dout,)), ("w1", (din, width)),
              ("w2", (width, dout))]
    plan = plan_for_params(layout, density,
                           spec.get("bucket_size", 64),
                           policy=spec.get("policy", "uniform"))
    comp = get_compressor(spec["selector"], density=density)
    exchange = spec.get("exchange", "allgather")
    gen = torch.Generator().manual_seed(seed)
    flat = torch.zeros(flat_numel(comp, plan, exchange))
    flat[:plan.total_numel] = 0.1 * torch.randn(plan.total_numel,
                                                generator=gen)
    params = torch.nn.Parameter(flat.to(device))
    views, off = {}, 0
    for name, shape in layout:
        views[name] = (off, shape)
        off += math.prod(shape)

    def leaf(name):
        o, shape = views[name]
        return params[o:o + math.prod(shape)].view(shape)

    def loss_fn(batch):
        x, y = batch
        h = torch.tanh(x @ leaf("w1") + leaf("b1"))
        out = h @ leaf("w2") + leaf("b2")
        mse = ((out - y) ** 2).mean()
        return mse, {"mse": mse.detach()}

    ts = DPTrainStep(loss_fn, params, {}, comp, plan,
                     optimizer=OptaxSGD(0.1), exchange=exchange,
                     wire=spec.get("wire", "auto"),
                     overlap=spec.get("overlap", "auto"))
    batch = (torch.randn(8, din, generator=gen).to(device),
             torch.randn(8, dout, generator=gen).to(device))
    return ts, batch


def run_arm(name: str, spec: Dict[str, Any], device,
            count_syncs: bool) -> Dict[str, Any]:
    """One arm: a first step, then ``WARM_STEPS`` warm steps with their
    collectives counted (and, with ``count_syncs``, their host syncs
    caught). Returns the arm's facts, its final state among them."""
    import torch
    from ..parallel.collectives import world_size
    ts, batch = build_arm(spec, device)
    state = ts.init_state()
    step = ts.dense_step if spec.get("dense") else ts.sparse_step
    step(state, batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    syncs: Optional[List[str]] = None
    with counted_collectives() as calls:
        if count_syncs:
            with caught_syncs() as syncs:
                for _ in range(WARM_STEPS):
                    step(state, batch)
        else:
            for _ in range(WARM_STEPS):
                step(state, batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    per_step: Optional[Dict[str, float]] = None
    if syncs is not None:
        per_step = {}
        for s in syncs:
            per_step[s] = per_step.get(s, 0) + 1
        per_step = {s: n / WARM_STEPS for s, n in sorted(per_step.items())}
    final = {"params": state.params.detach().cpu().clone(),
             "ef_residual": state.ef_residual.cpu().clone(),
             **{f"opt {k}": v.cpu().clone()
                for k, v in state.opt_state.items()}}
    if state.comp_state is not None:
        final["comp_state"] = state.comp_state.cpu().clone()
    return {
        "config": {k: v for k, v in spec.items()
                   if k not in ("expect", "identity")},
        "wire_format": ts.wire_format,
        "overlap": "off" if spec.get("dense") else ts.overlap,
        "ef_numel": int(ts.ef_numel),
        "fused_ef": ts.fused_ef is not None,
        "n_buckets": len(ts.plan.buckets),
        "world": world_size(),
        "collectives": inventory(calls, WARM_STEPS),
        "syncs": per_step,
        "_state": final,
    }


def check_contracts(arm: str, spec: Dict[str, Any], built: Dict[str, Any]
                    ) -> List[str]:
    """Violation strings for one arm (empty == every contract holds)."""
    bad: List[str] = []
    for key, want in expected(spec, built["world"]).items():
        got = built.get(key)
        if got != want:
            bad.append(f"{arm}: build reported {key}={got!r}, "
                       f"expected {want!r}")
    inv = built["collectives"]
    payload = sum(inv.get(p, {}).get("total", 0)
                  for p in PAYLOAD_COLLECTIVES)
    inside = sum(inv.get(p, {}).get("in_pipeline", 0)
                 for p in PAYLOAD_COLLECTIVES)
    reduced = sum(inv.get(r, {}).get("total", 0) for r in REDUCTIONS)
    if spec.get("dense"):
        if payload:
            bad.append(f"{arm}: dense step must not issue payload "
                       f"collectives, found {payload} a step")
        if not reduced:
            bad.append(f"{arm}: dense step issues no all-reduce")
    elif built["overlap"] == "pipelined":
        if inside < built["n_buckets"]:
            bad.append(f"{arm}: pipelined build issues {inside} payload "
                       f"collective(s) a step inside the pipelined phase, "
                       f"fewer than its {built['n_buckets']} chunks — the "
                       f"exchange is not overlapped with compression")
    else:
        if inside:
            bad.append(f"{arm}: sequential build issues {inside} payload "
                       f"collective(s) inside the pipelined phase")
        if spec.get("exchange") == "gtopk":
            want = int(math.log2(built["world"]))
        else:
            want = 2 if built["wire_format"] == "i32f32" else 1
        if payload != want:
            bad.append(f"{arm}: sequential build issues {payload} payload "
                       f"collective(s) a step, expected {want} (one a "
                       f"payload tensor of the whole plan, or gtopk's "
                       f"log2(P) hops)")
    if built["syncs"] is not None:
        allowed = allowed_syncs(arm, built["n_buckets"]
                                if built["overlap"] == "pipelined" else 1)
        for site, n in built["syncs"].items():
            if site not in allowed:
                bad.append(f"{arm}: {n:g} unlisted host sync(s) a warm "
                           f"step at {site}")
            elif n > allowed[site][0]:
                bad.append(f"{arm}: {n:g} host syncs a warm step at {site}"
                           f", more than the {allowed[site][0]} allowed "
                           f"({allowed[site][1]})")
    return bad


def _states_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    import torch
    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


# ---------------------------------------------------------------------------
# running the audit
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _group_of_one(device):
    """A process group of one rank (NCCL on the card, gloo on the CPU)
    unless one exists; torn down after."""
    import torch.distributed as dist
    from ..parallel.mesh import init_distributed
    if dist.is_available() and dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(device, 0, 1,
                         "file://" + os.path.join(tmp, "store"))
        try:
            yield
        finally:
            dist.destroy_process_group()


def run_audit(arm_names: Optional[Sequence[str]] = None,
              device: Optional[str] = None) -> Dict[str, Any]:
    """Run and audit every requested arm on ``device`` (default ``cuda``;
    ``cpu`` only when asked) in the process group, or one of a rank;
    returns the full report (no ratchet comparison here — see
    :func:`compare_programs`)."""
    import torch
    from ..device import resolve_device

    names = list(arm_names) if arm_names else list(ARMS)
    unknown = [n for n in names if n not in ARMS]
    if unknown:
        raise KeyError(f"unknown arm(s): {', '.join(unknown)} "
                       f"(available: {', '.join(ARMS)})")
    dev = resolve_device(device)
    count_syncs = dev.type == "cuda"
    arms: Dict[str, Any] = {}
    states: Dict[str, Any] = {}
    violations: List[str] = []
    with _group_of_one(dev):
        import torch.distributed as dist
        backend = dist.get_backend()
        for name in names:
            spec = ARMS[name]
            try:
                built = run_arm(name, spec, dev, count_syncs)
            except Exception as e:  # a build/run failure IS a finding
                violations.append(
                    f"{name}: build/run failed: {type(e).__name__}: {e}")
                arms[name] = {"error": f"{type(e).__name__}: {e}"}
                continue
            states[name] = built.pop("_state")
            calls = (built["n_buckets"] if built["overlap"] == "pipelined"
                     else 1)
            built["syncs_allowed"] = {
                site: n for site, (n, _) in allowed_syncs(name,
                                                          calls).items()}
            arms[name] = built
            violations.extend(check_contracts(name, spec, built))

    identities: List[Dict[str, Any]] = []
    groups: Dict[str, List[str]] = {}
    for name in names:
        g = ARMS[name].get("identity")
        if g:
            groups.setdefault(g, []).append(name)
    for g, members in groups.items():
        if len(members) < 2:
            continue  # subset run: nothing to compare
        if any(m not in states for m in members):
            violations.append(f"identity '{g}': an arm failed to run")
            identities.append({"group": g, "arms": members,
                               "equal": False})
            continue
        first = members[0]
        same_build = all(
            (arms[m]["wire_format"], arms[m]["overlap"])
            == (arms[first]["wire_format"], arms[first]["overlap"])
            for m in members)
        same_bits = all(_states_equal(states[first], states[m])
                        for m in members[1:])
        equal = same_build and same_bits
        identities.append({"group": g, "arms": members, "equal": equal,
                           "same_build": same_build,
                           "same_bits": same_bits})
        if not equal:
            violations.append(
                f"identity '{g}' broken across {members}: "
                f"{'builds differ' if not same_build else ''}"
                f"{'; ' if not (same_build or same_bits) else ''}"
                f"{'states differ in their bits' if not same_bits else ''}"
                f" — an 'off/ineligible' path no longer commits the bits "
                f"of its reference build")

    return {
        "version": PROGRAMS_VERSION,
        "tool": "gklint-audit",
        "torch_version": torch.__version__,
        "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else None),
        "backend": backend,
        "warm_steps": WARM_STEPS,
        "syncs": ("counted" if count_syncs else
                  "not counted: the CPU has no device to wait for (the "
                  "contract is skipped, not passed)"),
        "arms": arms,
        "identities": identities,
        "violations": violations,
        "ok": not violations,
    }


# ---------------------------------------------------------------------------
# the committed inventory ratchet
# ---------------------------------------------------------------------------

def programs_snapshot(report: Dict[str, Any]) -> Dict[str, Any]:
    """The subset of a report committed to ``.gklint-torch-programs.json``:
    each arm's build and collective inventory (device-independent)."""
    return {
        "version": PROGRAMS_VERSION,
        "world": next((a["world"] for a in report["arms"].values()
                       if "world" in a), None),
        "arms": {
            name: {key: arm[key] for key in ("wire_format", "overlap",
                                             "ef_numel", "fused_ef",
                                             "n_buckets", "collectives")}
            for name, arm in sorted(report["arms"].items())
            if "error" not in arm},
    }


def load_programs(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) or "arms" not in data:
        return None
    return data


def compare_programs(report: Dict[str, Any], baseline: Dict[str, Any],
                     partial: bool = False) -> Tuple[List[str], List[str]]:
    """(violations, warnings) from checking a report against the committed
    snapshot. ``partial`` (an ``--arms`` subset run) skips missing-arm
    checks; a snapshot taken at another world size only warns."""
    violations: List[str] = []
    warnings_: List[str] = []
    current = programs_snapshot(report)
    if baseline.get("world") != current["world"]:
        warnings_.append(
            f"committed inventory was taken at a world of "
            f"{baseline.get('world')}, this run's is {current['world']}: "
            f"the inventory drift is NOT gating this run (the structural "
            f"contracts still are)")
        return violations, warnings_
    committed = baseline["arms"]
    for name, arm in current["arms"].items():
        if name not in committed:
            violations.append(
                f"{name}: no committed inventory — a new arm must be "
                f"baselined explicitly (--write-programs)")
        elif committed[name] != arm:
            violations.append(
                f"{name}: step inventory drifted ({committed[name]} -> "
                f"{arm}); if intended, re-baseline with --write-programs "
                f"so the change is an explicit reviewed diff")
    if not partial:
        for name in sorted(set(committed) - set(current["arms"])):
            violations.append(
                f"{name}: committed inventory has no current arm — "
                f"removed arms must be re-baselined (--write-programs)")
    return violations, warnings_
