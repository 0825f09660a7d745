"""No JAX on the benchmark's path: the check compares top-level names whole,
and the reference imports neither the JAX package nor the program."""

import subprocess
import sys

from benchmark import harness


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "enerf_tpu_notes", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert "enerf_tpu_notes" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


def loaded_after(code):
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
                        "for m in sys.modules}))"], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    return eval(p.stdout.strip().splitlines()[-1])


def test_the_reference_imports_neither_jax_nor_the_program():
    mods = loaded_after("import benchmark.reference.train, benchmark.reference.render, "
                        "benchmark.reference.batch, benchmark.reference.field")
    for name in ("jax", "jaxlib", "flax", "enerf_tpu", "enerf_torch"):
        assert name not in mods


def test_the_harness_and_a_cpu_run_load_no_jax():
    mods = loaded_after("from benchmark.tests.tiny_cells import run_tiny\n"
                        "run_tiny('mocapDesk2_enerf.train')\nrun_tiny('spiral1_nerf.render')")
    for name in ("jax", "jaxlib", "flax", "enerf_tpu"):
        assert name not in mods
    assert "enerf_torch" in mods
