"""The PyTorch port stands alone: importing it (its parallel package
included) loads neither jax nor band_tpu (nor PIL, grpc, protobuf or
TensorFlow), no file of the port (nor chip_smoke.py) imports jax or
band_tpu, and only the gRPC front-end
imports grpc or protobuf at module level."""

import glob
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    p for p in glob.glob(os.path.join(ROOT, "band_tpu_torch", "**", "*.py"),
                         recursive=True)
    if "_build" not in os.path.relpath(p, ROOT).split(os.sep)
) + [os.path.join(ROOT, "chip_smoke.py")]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|band_tpu)\b(?!_torch)"
    r"|from\s+(jax|band_tpu)\b(?!_torch)[\w.]*\s+import)",
    re.MULTILINE,
)


def test_import_leaves_jax_and_band_tpu_out():
    code = (
        "import sys\n"
        "import band_tpu_torch\n"
        "import band_tpu_torch.backend.executor, band_tpu_torch.ops.kernels\n"
        "import band_tpu_torch.tools.benchmark\n"
        "import band_tpu_torch.monitor.resource_monitor\n"
        "import band_tpu_torch.buffer.processor, band_tpu_torch.buffer.synthetic\n"
        "import band_tpu_torch.tools.server, band_tpu_torch.tools.router\n"
        "import band_tpu_torch.tools.evaluate\n"
        "import band_tpu_torch.tools.preprocess_bench\n"
        "import band_tpu_torch.c._embed, band_tpu_torch.c.build\n"
        "import band_tpu_torch.parallel.distributed\n"
        "import band_tpu_torch.parallel.mesh, band_tpu_torch.parallel.spmd\n"
        "import band_tpu_torch.parallel.sharding\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'band_tpu',\n"
        "                                    'PIL', 'grpc', 'tensorflow')\n"
        "             or m.startswith('google.protobuf'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_port_file_imports_jax_or_band_tpu(path):
    with open(path) as f:
        src = f.read()
    assert not FORBIDDEN.search(src), FORBIDDEN.search(src).group(0)


def test_chip_smoke_refuses_without_cuda_or_the_package(tmp_path):
    """Run without a card (or alone in a directory), chip_smoke.py exits
    non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs its absence")
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        alone.write_text(f.read())
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT),
                        (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


GRPC_FILES = {os.path.join(ROOT, "band_tpu_torch", "tools", f)
              for f in ("grpc_server.py", "band_grpc_pb2.py")}
HEAVY = re.compile(r"^\s*(import|from)\s+(grpc|google\.protobuf|PIL|tensorflow)\b",
                   re.MULTILINE)
TOP_LEVEL_HEAVY = re.compile(
    r"^(import|from)\s+(grpc|google\.protobuf|PIL|tensorflow)\b",
    re.MULTILINE)


@pytest.mark.parametrize("path", [p for p in PORT_FILES
                                  if p not in GRPC_FILES],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_heavy_imports_stay_lazy(path):
    """PIL and TensorFlow only inside the functions that need them (the
    tools' image and oracle paths), grpc and protobuf only in the gRPC
    front-end, and none of them in chip_smoke.py: the card machine may
    lack them all."""
    with open(path) as f:
        src = f.read()
    pattern = HEAVY if path.endswith("chip_smoke.py") else TOP_LEVEL_HEAVY
    assert not pattern.search(src), pattern.search(src).group(0)
