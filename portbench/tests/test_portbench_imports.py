"""What a run loads, and that it never reports without a card."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.tests.conftest import ROOT, TINY

SETUP_PATH = r"""
import json, sys, time
t = time.perf_counter()
root = sys.argv[1]
sys.path.insert(0, root)
sys.path.append(sys.argv[2])
from portbench import harness
harness.WARM_SECONDS = 0.5  # as tiny_root sets it
results = {}
for cell in sys.argv[3:]:
    r = harness.run_cell(root, cell, 2**31 + 7, 0.5, False, "cpu", t)
    results[cell] = r["correct"]
print(json.dumps(dict(correct=results,
                      top=sorted({m.split(".", 1)[0] for m in sys.modules}))))
"""


def test_cells_load_neither_jax_nor_band_tpu(tiny_root):
    out = subprocess.run(
        [sys.executable, "-c", SETUP_PATH, tiny_root, ROOT, *TINY],
        capture_output=True, text=True, timeout=600, cwd=tiny_root,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        | {"PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(got["correct"].values()), got["correct"]
    top = set(got["top"])
    assert "band_tpu_torch" in top  # the program ran ...
    for name in ("jax", "jaxlib", "flax", "band_tpu"):  # ... and not these
        assert name not in top, name


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(ROOT, "portbench", "reference")
    for path in glob.glob(os.path.join(ref_dir, "*.py")):
        bad = _imports(path) & {"band_tpu_torch", "band_tpu", "jax",
                                "jaxlib", "flax"}
        assert not bad, (path, bad)
    code = ("import sys; import portbench.reference.interp, "
            "portbench.reference.kernels, portbench.reference.tflite; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"band_tpu_torch", "band_tpu", "jax"}, top


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload",
         "mnv2_int8.stream", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA" in out.stderr


def test_only_the_benchmark_is_no_result(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone: no program to
    run, so no result (and never the CPU's numbers)."""
    from portbench.tests.conftest import copy_benchmark

    root = copy_benchmark(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload",
         "fsrcnn_x2_int8.video", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=root, env=env)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
