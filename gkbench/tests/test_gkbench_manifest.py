"""BENCHMARK.json against the benchmark's contract, and the harness
finding what is added as files alone."""

import json
import shutil

import pytest

from gkbench import check, manifest, reference, traffic

BENCH = manifest.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection",
          "head", "expansion", "experts_per_tok")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entry_keys():
    assert set(BENCH) == TOP_KEYS
    for kind, keys in ENTRY_KEYS.items():
        for entry in BENCH[kind]:
            extra = set(entry) - keys - ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set())
            assert set(entry) >= keys and not extra, (kind, entry)


def test_names_units_and_lines():
    names = [e["name"] for kind in ENTRY_KEYS for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for name in names:
        assert manifest.NAME.match(name), name
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert manifest.UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert manifest.NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTHS), key
    for w in BENCH["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert manifest.NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word


def test_bounds_sources_and_lengths():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits
    cells = 24
    assert ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
            + cells * 2 * 90 + 1200) <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_and_its_files_load():
    config_names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (manifest.ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for w in BENCH["workloads"]:
        assert w["config"] in config_names
        cell = manifest.load_cell(w["name"], BENCH)
        # the control fails one of them (PERF.md); each has a limit
        assert cell.setup["limits"] and set(cell.setup["limits"]) <= set(
            check.NUMBERS)
        for kind in ("end_to_end", "per_layer"):
            # every cell reports setup_s, another end-to-end metric and a
            # per-layer one
            assert manifest.metrics_for(BENCH, w["name"], kind)
        # a per-layer metric's cell reports the metric it moves
        e2e = {m["name"] for m in manifest.metrics_for(BENCH, w["name"],
                                                       "end_to_end")}
        assert len(e2e) >= 2 and "setup_s" in e2e
        for m in manifest.metrics_for(BENCH, w["name"], "per_layer"):
            assert m["moves"] in e2e, (w["name"], m["name"])
        # its model's reference and its traffic's generator are found
        assert reference.build(cell.config["architecture"]).layout
        assert traffic.generator(cell.traffic).input_spec(cell.traffic, 2)
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert callable(manifest.reader(m["name"]).read)
            for cell in m.get("workloads", []):
                assert cell in {w["name"] for w in BENCH["workloads"]}


def test_a_cell_metric_and_config_added_as_files_are_found(tmp_path):
    base = tmp_path / "gkbench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(manifest.HERE / sub, base / sub)
    config = json.loads((base / "configs" / "vgg16-cifar10-gk.json")
                        .read_text())
    config["train"]["batch_size"] = 64
    (base / "configs" / "vgg16-b64.json").write_text(json.dumps(config))
    traffic = json.loads((base / "traffic" / "cifar10-b1024-closed.json")
                         .read_text())
    (base / "traffic" / "cifar10-b64-closed.json").write_text(
        json.dumps(dict(traffic, global_batch=64)))
    (base / "workloads" / "vgg16-b64-1c.json").write_text(
        (base / "workloads" / "vgg16-gk-1c.json").read_text())
    (base / "metrics" / "steps_done.py").write_text(
        "def read(ctx):\n    return ctx.steps\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="vgg16-b64",
                                 file="gkbench/configs/vgg16-b64.json"))
    bench["workloads"].append({"name": "vgg16-b64-1c", "config": "vgg16-b64",
                               "traffic": "cifar10-b64-closed", "chips": 1,
                               "why": "batch 64"})
    bench["per_layer"].append({"name": "steps_done", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer loop",
                               "moves": "samples_per_s",
                               "workloads": ["vgg16-b64-1c"]})
    cell = manifest.load_cell("vgg16-b64-1c", bench, base)
    assert cell.global_batch == 64
    names = [m["name"] for m in manifest.metrics_for(bench, cell.name,
                                                     "per_layer")]
    assert "steps_done" in names and "exchange_ms" not in names
    assert manifest.reader("steps_done", base).read(
        type("Ctx", (), {"steps": 7})) == 7


def test_a_mismatched_traffic_is_refused():
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "imagenet-b64-closed"
    with pytest.raises(ValueError, match="global batches"):
        manifest.load_cell(bench["workloads"][0]["name"], bench)


def test_a_model_family_and_a_generator_added_as_files_are_found(tmp_path):
    from gkbench import reference, traffic
    base = tmp_path / "gkbench"
    (base / "reference").mkdir(parents=True)
    (base / "generators").mkdir()
    (base / "reference" / "toy.py").write_text(
        "from . import models\n"
        "from .sgd import Model\n\n"
        "def build(arch):\n"
        "    leaves = {'Dense_0/kernel': (arch['width'], 2)}\n"
        "    return Model(models.flat_layout(leaves), None)\n")
    (base / "generators" / "tokens.py").write_text(
        "def make_pool(traffic, seed, device):\n"
        "    return [('x', 'y')] * traffic['pool_batches']\n")
    model = reference.build({"model": "toy", "width": 3}, base)
    assert model.layout == [("Dense_0/kernel", (3, 2))]
    gen = traffic.generator({"generator": "tokens"}, base)
    assert len(gen.make_pool({"pool_batches": 2}, 0, None)) == 2
    with pytest.raises(ValueError, match="add gkbench/reference/nope.py"):
        reference.build({"model": "nope"}, base)
    with pytest.raises(ValueError, match="is no model"):
        reference.build({"model": "sgd"})
