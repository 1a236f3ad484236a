"""Nothing the benchmark loads imports JAX or the JAX package, and the
reference imports nothing of the program.  Each check runs in a fresh
interpreter, compares top-level module names whole (the port's name begins
with the JAX package's), and scans the sources beside it."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.BENCH
FORBIDDEN = ["jax", "jaxlib", "flax", "dvs_mcemvs_tpu"]
NOT_IMPORTED = FORBIDDEN + ["bench", "bench_torch", "chip_smoke", "scripts"]


def _loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path.insert(0, {harness.ROOT!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_metrics_and_reference_load_no_jax():
    readers = [os.path.basename(p)[:-3] for p in glob.glob(os.path.join(BENCH, "metrics", "*.py"))]
    code = ("from benchmark import harness, judge, profiling, faults, calibrate\n"
            "from benchmark.reference import emvs\n"
            "import benchmark.run\n"
            "import dvs_mcemvs_torch.cli, dvs_mcemvs_torch.pipeline, dvs_mcemvs_torch.mapper\n"
            f"for n in {readers!r}: harness.metric_reader(n)\n")
    loaded = _loaded_after(code)
    assert not loaded & set(NOT_IMPORTED), loaded & set(NOT_IMPORTED)
    assert "dvs_mcemvs_torch" in loaded    # the port itself, a different top-level name


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("from benchmark.reference import emvs")
    assert "dvs_mcemvs_torch" not in loaded and not loaded & set(FORBIDDEN)


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "**", "*.py"),
                                               recursive=True)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_sources_import_no_jax(path):
    names = _imports(path)
    assert not names & set(NOT_IMPORTED), (path, names & set(NOT_IMPORTED))
    if os.sep + "reference" + os.sep in path:
        assert "dvs_mcemvs_torch" not in names and "benchmark" not in names
