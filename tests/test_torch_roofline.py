"""The port's card-priced roofline floor (``gaussiank_sgd_torch/
roofline.py``) and its loader (``policy/rules.py:load_roofline_floor``)
against the reference's ``analysis/roofline.py``.

* ``param_count`` (the model's layout on the meta device), nc, k, the
  fused and unfused bytes and the exchange bytes of the five BASELINE
  configs equal the committed ``analysis/artifacts/roofline.json``'s: the
  bytes do not depend on the platform that priced the floors.
* ``floor_bytes`` and ``exchange_bytes`` equal the reference's functions
  at other sizes, densities and worker counts.
* The loader: on ``cuda`` the port's artifact, applied only on a card of
  the name it was priced on (a matching name, a foreign one, none, an
  absent file); on ``cpu`` the reference's artifact, as before.
* A small bandwidth probe on the CPU gives a positive rate; ``main`` on
  the CPU writes the artifact's fields where ``--out`` says.
* The committed ``gaussiank_sgd_torch/artifacts/roofline.json`` was priced
  on the card, names it and its power limit, and holds the reference's
  bytes.
"""

import json
import os

import pytest

from analysis import roofline as jroof
from gaussiank_sgd_torch import roofline
from gaussiank_sgd_torch.policy.rules import load_roofline_floor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "analysis", "artifacts", "roofline.json")) as f:
    REF = json.load(f)
BYTE_FIELDS = ("params", "k", "candidates", "fused_bytes", "unfused_bytes",
               "exchange_bytes_allgather", "exchange_bytes_gtopk")


def _bytes(n, density=0.001, nworkers=8):
    fused, unfused, nc, k = roofline.floor_bytes(n, density)
    ag, gt = roofline.exchange_bytes(k, nworkers)
    return {"params": n, "k": k, "candidates": nc, "fused_bytes": fused,
            "unfused_bytes": unfused, "exchange_bytes_allgather": ag,
            "exchange_bytes_gtopk": gt}


@pytest.mark.parametrize("key,model,dataset", roofline.CONFIG_MODELS)
def test_bytes_equal_the_reference_artifacts(key, model, dataset):
    assert roofline.CONFIG_MODELS == jroof.CONFIG_MODELS
    n = roofline.param_count(model, dataset)
    want = {f: REF["configs"][key][f] for f in BYTE_FIELDS}
    assert _bytes(n, REF["density"], REF["nworkers"]) == want


def test_vgg16_geometry_and_the_k_gap():
    """nc at VGG-16 is R = 1024, SEG = 64, 115 blocks; k is the
    reference's int(n * density), one below the step's k_for."""
    from gaussiank_sgd_torch.compressors import k_for
    from gaussiank_sgd_torch.ops.fused_select import _chunk_geometry
    n = roofline.param_count("vgg16", "cifar10")
    assert _chunk_geometry(n, 0.001) == (1024, 64, 115, 235_520)
    assert roofline.floor_bytes(n, 0.001)[2:] == (235_520, 14_986)
    assert k_for(n, 0.001) == 14_987


@pytest.mark.parametrize("n,density", [(1, 0.001), (4097, 0.01),
                                       (1_000_003, 0.001), (65_536, 0.03),
                                       (2_000_000, 0.05), (123_457, 0.1)])
def test_floor_bytes_equal_the_references(n, density):
    assert roofline.floor_bytes(n, density) == jroof.floor_bytes(n, density)
    assert (roofline.floor_bytes(n, density, 8)
            == jroof.floor_bytes(n, density, 8))


@pytest.mark.parametrize("nworkers", [1, 2, 3, 8, 12, 64])
def test_exchange_bytes_equal_the_references(nworkers):
    for k in (1, 269, 60_524):
        for bpe in (4, 8):
            assert (roofline.exchange_bytes(k, nworkers, bpe)
                    == jroof.exchange_bytes(k, nworkers, bpe))


def _artifact(tmp_path, **fields):
    d = tmp_path / "art"
    d.mkdir(exist_ok=True)
    (d / "roofline.json").write_text(json.dumps({
        "platform": "cuda", "device": "NVIDIA H100 80GB HBM3",
        "configs": {"vgg16": {"floor_ms": 0.07}}, **fields}))
    return str(d)


def test_loader_on_the_card_wants_the_cards_name(tmp_path):
    art = _artifact(tmp_path)
    name = "NVIDIA H100 80GB HBM3"
    assert load_roofline_floor("vgg16", "cuda", art, device_name=name) == 0.07
    assert load_roofline_floor("VGG16", "cuda", art, device_name=name) == 0.07
    for other in ("NVIDIA H100 PCIe", None):
        assert load_roofline_floor("vgg16", "cuda", art,
                                   device_name=other) is None
    assert load_roofline_floor("mnistnet", "cuda", art,
                               device_name=name) is None
    assert load_roofline_floor("vgg16", "cpu", art, device_name=name) is None
    assert load_roofline_floor("vgg16", "cuda", str(tmp_path / "none"),
                               device_name=name) is None


def test_loader_on_the_cpu_reads_the_references_artifact():
    """Without ``artifacts``: ``cpu`` reads ``analysis/artifacts``, as it
    did before the port priced its own floor."""
    for key, model, _ in roofline.CONFIG_MODELS:
        assert load_roofline_floor(model, "cpu") == REF["configs"][key][
            "floor_ms"]
    assert load_roofline_floor("mnistnet", "cpu") is None


def test_loader_on_the_card_reads_the_ports_artifact():
    with open(os.path.join(roofline.ARTIFACTS, "roofline.json")) as f:
        port = json.load(f)
    for key, model, _ in roofline.CONFIG_MODELS:
        assert load_roofline_floor(model, "cuda",
                                   device_name=port["device"]) == port[
            "configs"][key]["floor_ms"]
        assert load_roofline_floor(model, "cuda",
                                   device_name="another card") is None


def test_committed_artifact_was_priced_on_the_card():
    with open(os.path.join(roofline.ARTIFACTS, "roofline.json")) as f:
        port = json.load(f)
    assert port["platform"] == "cuda"
    assert port["device"].startswith("NVIDIA")
    assert port["power_limit"].endswith(" W")
    assert port["density"] == REF["density"]
    assert port["nworkers"] == REF["nworkers"]
    assert port["bandwidth_gbps"] > 500
    for key, cell in port["configs"].items():
        assert {f: cell[f] for f in BYTE_FIELDS} == {
            f: REF["configs"][key][f] for f in BYTE_FIELDS}
        # the floor is priced at the unrounded rate; the file keeps it to
        # 0.01 GB/s and the floor to 0.001 ms
        assert abs(cell["floor_ms"] - 1e3 * cell["fused_bytes"]
                   / (port["bandwidth_gbps"] * 1e9)) <= 6e-4


def test_cpu_probe_and_main_write_where_asked(tmp_path, capsys):
    gbps, rounds = roofline.measure_bandwidth_gbps(100_000, n_steps=3,
                                                   rounds=3, device="cpu")
    assert gbps > 0 and len(rounds) == 3 and all(r > 0 for r in rounds)
    out = tmp_path / "roof.json"
    (tmp_path / "bench_last.json").write_text(json.dumps({"detail": {
        "platform": "cpu", "configs": {"vgg16": {
            "sparse_step_ms": 12.5, "dense_step_ms": 12.0}}}}))
    res = roofline.main(["--device", "cpu", "--bw-gbps", "100",
                         "--configs", "vgg16", "resnet20",
                         "--out", str(out)])
    assert json.load(open(out)) == json.loads(json.dumps(res))
    assert (res["platform"], res["device"], res["power_limit"]) == (
        "cpu", "cpu", None)
    assert set(res["configs"]) == {"vgg16", "resnet20"}
    vgg = res["configs"]["vgg16"]
    assert vgg["floor_ms"] == round(1e3 * vgg["fused_bytes"] / 1e11, 3)
    assert vgg["achieved_overhead_ms"] == 0.5
    assert "achieved_overhead_ms" not in res["configs"]["resnet20"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["floors_ms"] == {k: c["floor_ms"]
                                 for k, c in res["configs"].items()}
