"""Nothing the benchmark loads is JAX or the JAX package (compared by whole
top-level name: the port's name begins with the JAX package's), and the
reference imports nothing of the port."""
import ast
import subprocess
import sys

from benchmark import harness

FORBIDDEN = set(harness.FORBIDDEN)


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
         "for m in sys.modules}))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax():
    code = ("import time, torch\n"
            "from benchmark import harness, run, calibrate\n"
            "from benchmark.tests import tiny\n"
            "from benchmark.traffic import generate\n"
            "c = tiny.cell('i2v512.ddim50', steps=2, max_clips=1, check_clips=1, check_calls=2)\n"
            "generate.run(c, seed=5, seconds=0.1, trace=True, device=torch.device('cpu'),\n"
            "             clock=harness.SetupClock(time.perf_counter()),\n"
            "             program=tiny.program(c.config))\n"
            "for m in c.per_layer: harness.metric_reader(m['name'])\n")
    loaded = _loaded_after(code)
    assert "dynamicrafter_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.model, benchmark.reference.diffusion, "
                           "benchmark.reference.layers, benchmark.weights")
    assert not loaded & (FORBIDDEN | {"dynamicrafter_tpu_torch"})
    for path in (harness.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"dynamicrafter_tpu_torch"}, (path, n)
