"""The port's step audit (``gaussiank_sgd_torch/lint/program_audit.py``,
``python -m gaussiank_sgd_torch.lint audit``) at a world of one on the CPU.

* Its 13 arms are the reference's ``ARMS``, name for name and spec for
  spec.
* The collective inventory of every arm is the committed
  ``.gklint-torch-programs.json``, and its contracts hold: the pipelined
  builds issue one payload collective a chunk inside the pipelined phase
  (``gaussian_fused_pipe_wire``, din 64 and width 256 as the reference's
  arm, 139 chunks), the sequential builds one a payload tensor outside
  it, and ``dense_reference`` only all-reduces.
* Both identities hold: the paired arms build the same wire and schedule
  and commit the same bits.
* A broken identity, a drifted inventory and an unlisted sync are caught.
* The host-sync contract is not counted on the CPU: the report says so.
"""

import json

import pytest

from gaussiank_sgd_tpu.lint.program_audit import ARMS as REF_ARMS
from gaussiank_sgd_torch.lint import program_audit as pa
from gaussiank_sgd_torch.lint.__main__ import main


@pytest.fixture(scope="module")
def report():
    return pa.run_audit(device="cpu")


def test_the_arms_are_the_references():
    assert pa.ARMS == REF_ARMS


def test_inventory_and_identities_hold_on_the_cpu(report):
    assert report["violations"] == [] and report["ok"]
    assert report["backend"] == "gloo" and report["device"] == "cpu"
    assert report["syncs"].startswith("not counted")
    committed = pa.load_programs(pa.default_programs_path())
    assert pa.compare_programs(report, committed) == ([], [])
    fused = report["arms"]["gaussian_fused_pipe_wire"]
    assert (fused["wire_format"], fused["overlap"], fused["n_buckets"]) \
        == ("u16bf16", "pipelined", 139)
    assert fused["collectives"]["all_gather_async"] == {
        "total": 139, "in_pipeline": 139}
    assert report["arms"]["allgather_seq_legacy"]["collectives"][
        "all_gather"] == {"total": 2, "in_pipeline": 0}
    dense = report["arms"]["dense_reference"]["collectives"]
    assert set(dense) == {"all_reduce_sum", "pmean"}
    # at a world of one gtopk's pipelined gate has no round-1 partner
    assert report["arms"]["gtopk_pipe_wire"]["overlap"] == "off"
    assert pa.expected(pa.ARMS["gtopk_pipe_wire"], 2)["overlap"] \
        == "pipelined"
    groups = {i["group"]: (i["same_build"], i["same_bits"])
              for i in report["identities"]}
    assert groups == {"wire-ineligible-equals-legacy": (True, True),
                      "overlap-ineligible-equals-off": (True, True)}
    for arm in report["arms"].values():
        assert arm["syncs"] is None


def test_the_checks_catch_what_they_guard(report):
    # a drifted inventory
    committed = pa.load_programs(pa.default_programs_path())
    drifted = json.loads(json.dumps(committed))
    drifted["arms"]["allgather_seq_wire"]["collectives"]["all_gather"][
        "total"] = 2
    bad, _ = pa.compare_programs(report, drifted)
    assert len(bad) == 1 and "allgather_seq_wire" in bad[0]
    # a sequential build that gathered inside the pipelined phase, a
    # pipelined one that did not, and an unlisted or excess host sync
    seq = dict(report["arms"]["allgather_seq_wire"],
               collectives={"all_gather": {"total": 1, "in_pipeline": 1}})
    assert any("inside the pipelined phase" in v for v in
               pa.check_contracts("allgather_seq_wire",
                                  pa.ARMS["allgather_seq_wire"], seq))
    pipe = dict(report["arms"]["allgather_pipe_wire"],
                collectives={"all_gather": {"total": 1, "in_pipeline": 0}})
    assert any("not overlapped" in v for v in pa.check_contracts(
        "allgather_pipe_wire", pa.ARMS["allgather_pipe_wire"], pipe))
    site = next(iter(pa.SYNC_ALLOWED))
    fused = report["arms"]["gaussian_fused_pipe_wire"]
    spec = pa.ARMS["gaussian_fused_pipe_wire"]
    assert pa.check_contracts("gaussian_fused_pipe_wire", spec,
                              dict(fused, syncs={site: 139})) == []
    assert any("more than" in v for v in pa.check_contracts(
        "gaussian_fused_pipe_wire", spec, dict(fused, syncs={site: 140})))
    assert any("unlisted" in v for v in pa.check_contracts(
        "allgather_seq_wire", pa.ARMS["allgather_seq_wire"],
        dict(report["arms"]["allgather_seq_wire"], syncs={site: 1})))


def test_a_broken_identity_is_caught(monkeypatch):
    real = pa.build_arm

    def skewed(spec, device, seed=0):
        # the legacy twin's step starts from other weights
        return real(spec, device,
                    seed=1 if spec.get("wire") == "off" else seed)
    monkeypatch.setattr(pa, "build_arm", skewed)
    rep = pa.run_audit(["greedy_wire_auto_ineligible",
                        "greedy_wire_off_legacy"], device="cpu")
    (ident,) = rep["identities"]
    assert not ident["equal"] and ident["same_build"]
    assert any("states differ" in v for v in rep["violations"])


def test_cli_lists_the_arms_and_runs_a_subset(capsys, tmp_path):
    assert main(["audit", "--list-arms"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in pa.ARMS)
    assert main(["audit", "--device", "cpu", "--arms",
                 "singlebucket_overlap_auto_ineligible,"
                 "singlebucket_overlap_off", "-o",
                 str(tmp_path / "a.json")]) == 0
    assert "identity overlap-ineligible-equals-off: ok" \
        in capsys.readouterr().out
    assert main(["audit", "--device", "cpu", "--arms", "nope"]) == 2


def test_a_sync_is_named_by_the_function_that_made_it():
    """The sites of the allow-list are ``path:function``, the function
    being the innermost one around the line the sync warning names."""
    import inspect
    src, first = inspect.getsourcelines(pa.build_arm)
    inner = first + next(i for i, line in enumerate(src)
                         if "def loss_fn" in line) + 2
    assert pa._site(pa.__file__, first + 1) \
        == "gaussiank_sgd_torch/lint/program_audit.py:build_arm"
    assert pa._site(pa.__file__, inner).endswith(":loss_fn")
    assert pa._site(pa.__file__, 1).endswith(":<module>")
    site = next(iter(pa.SYNC_ALLOWED))
    path, func = site.split(":")
    from gaussiank_sgd_torch.compressors import gaussian
    assert func in vars(gaussian) and path.endswith("compressors/gaussian.py")
