"""The check for JAX and the JAX package compares whole top-level names."""

import subprocess
import sys

from conftest import BENCH, REPO

import harness


def test_whole_top_level_names():
    assert harness.forbidden_modules(
        ["polar_tpu_torch", "polar_tpu_torch.ber", "jaxtyping", "flaxen",
         "torch"]) == []
    assert harness.forbidden_modules(
        ["polar_tpu", "polar_tpu.ber", "jax", "jax.numpy", "jaxlib",
         "flax.linen", "numpy"]) == ["flax.linen", "jax", "jax.numpy",
                                     "jaxlib", "polar_tpu", "polar_tpu.ber"]


def test_the_harness_and_the_program_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness, tracing, control, peaks\n"
        "from reference import polar, construction\n"
        "b = harness.Bench.from_file(%r)\n"
        "for w in b.spec['workloads']:\n"
        "    b.kind(b.traffic(w['traffic'])['kind'])\n"
        "for m in b.spec['per_layer']:\n"
        "    b.reader(m['name'])\n"
        "import polar_tpu_torch, polar_tpu_torch.ber\n"
        "print(harness.forbidden_modules())\n"
    ) % (str(BENCH), str(REPO), str(REPO / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from reference import polar, construction\n"
            "print(sorted(m for m in sys.modules if m.startswith('polar')))\n"
            ) % str(BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"
