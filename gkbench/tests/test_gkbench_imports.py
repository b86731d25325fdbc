"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program, comparing top-level module names
whole (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from gkbench import harness, manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "gaussiank_sgd_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax():
    for path in manifest.HERE.rglob("*.py"):
        assert not FORBIDDEN & set(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (manifest.HERE / "reference").rglob("*.py"):
        assert not (FORBIDDEN | {"gaussiank_sgd_torch"}) & set(
            _imports(path)), path


def test_the_check_compares_whole_top_level_names():
    sys.modules.setdefault("gaussiank_sgd_tpu_lookalike", sys)
    try:
        assert "gaussiank_sgd_tpu_lookalike" not in str(
            harness.forbidden_modules())
    finally:
        del sys.modules["gaussiank_sgd_tpu_lookalike"]
    assert harness.FORBIDDEN == tuple(sorted(FORBIDDEN, key=[
        "jax", "jaxlib", "flax", "gaussiank_sgd_tpu"].index))


def test_a_run_and_the_reference_load_no_jax():
    code = (
        "import sys\n"
        "from gkbench import run, harness, calibrate, worker\n"
        "from gkbench.tests.tiny import tiny_cell\n"
        "res = run.run_cell(tiny_cell(), 5, 0.3, False, 'cpu')\n"
        "import gaussiank_sgd_torch.training.trainer\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "bad = sorted(tops & {'jax', 'jaxlib', 'flax', 'gaussiank_sgd_tpu'})\n"
        "assert not bad, bad\n"
        "assert harness.forbidden_modules() == []\n"
        "assert 'gaussiank_sgd_torch' in tops\n")
    root = str(manifest.ROOT)
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_the_reference_runs_without_the_program():
    code = (
        "import sys\n"
        "sys.modules['gaussiank_sgd_torch'] = None\n"
        "import torch\n"
        "from gkbench import check, reference, traffic, weights\n"
        "from gkbench.reference import models\n"
        "m = reference.build({'model': 'vgg16', 'num_classes': 10,\n"
        "                     'image': [8, 8, 3], 'dropout': 0.5,\n"
        "                     'widths': [8, 'M', 16, 'M']})\n"
        "print(models.numel(m.layout))\n"
        "gen = traffic.generator({'generator': 'images'})\n"
        "assert 'gaussiank_sgd_torch' not in {\n"
        "    k.split('.')[0] for k, v in sys.modules.items() if v}\n")
    root = str(manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
