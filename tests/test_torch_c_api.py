"""The port's C ABI (band_tpu_torch/c): build libband_tpu_torch_c.so and
the three example programs with the host compiler, run them on a
CPU-worker config and tests/data models, and hold their outputs to the
goldens: main.c's sync request on a golden input byte-equal to TFLite
(tests/data/torch_goldens.npz); buffer_main.c's camera frames (RGB and
NV12) through BandImageProcessorProcess byte-equal to the port's Python
pipeline and within 1 code of band_tpu's, served byte-equal to TFLite on
the same tensor; the plain-C HTTP client against a live port server."""

import json
import os
import shutil
import subprocess
import threading

import numpy as np
import pytest

from band_tpu.buffer import buffer as jbuffer
from band_tpu.buffer import processor as jproc
from band_tpu_torch.buffer.buffer import BufferFormat
from band_tpu_torch.buffer.processor import ImageProcessorBuilder
from band_tpu_torch.buffer.synthetic import camera_frame, frame_bytes
from band_tpu_torch.c import build as cbuild
from tests.test_torch_buffer import _bytes_within_one
from tests.test_torch_frontends import MODEL_PATH, _cfg, _goldens

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CPU_CONFIG = {"schedulers": ["fixed_worker"],
              "workers": [{"device": "cpu", "device_ids": [0]}],
              "profile_num_warmups": 0, "profile_num_runs": 1}
# band_c.h BandBufferFormat
C_FORMAT = {BufferFormat.RGB: 1, BufferFormat.NV12: 6}


@pytest.fixture(scope="module")
def c_programs(tmp_path_factory):
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no C/C++ toolchain")
    out = tmp_path_factory.mktemp("c_api")
    lib = cbuild.build(str(out), quiet=True)
    exes = {n: cbuild.build_example(n, str(out))
            for n in ("main", "buffer_main")}
    exes["http_client_main"] = cbuild.build_example(
        "http_client_main", str(out), link_library=False)
    cfg = out / "cpu.json"
    cfg.write_text(json.dumps(CPU_CONFIG))
    return lib, exes, str(cfg), out


def _run(exe, *args):
    env = dict(os.environ, PYTHONPATH=cbuild.python_path())
    return subprocess.run([exe, *map(str, args)], env=env,
                          capture_output=True, text=True, timeout=300)


def _tflite(path, x):
    import tensorflow as tf

    it = tf.lite.Interpreter(
        model_path=path,
        experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType
            .BUILTIN_WITHOUT_DEFAULT_DELEGATES))
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    return it.get_tensor(it.get_output_details()[0]["index"])


def test_library_and_examples_build_outside_the_source(c_programs):
    lib, exes, _, out = c_programs
    assert os.path.basename(lib) == "libband_tpu_torch_c.so"
    for exe in exes.values():
        assert os.path.dirname(exe) == str(out) and os.access(exe, os.X_OK)
    assert not [f for f in os.listdir(cbuild.HERE) if f.endswith(".so")]
    # the default output directory is the package's gitignored _build/
    assert cbuild.BUILD_DIR == os.path.join(os.path.dirname(cbuild.HERE),
                                            "_build")


def test_c_api_round_trip(c_programs, tmp_path):
    """main.c on a CPU-worker config: register, a golden input through
    BandEngineRequestSync byte-equal to TFLite, async equal to sync,
    callbacks, unregister."""
    _, exes, cfg, _ = c_programs
    xs, want = _goldens()
    xs[0].tofile(tmp_path / "in.bin")
    proc = _run(exes["main"], MODEL_PATH, cfg, tmp_path / "in.bin",
                tmp_path / "out", 2)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    out = proc.stdout
    for line in ("log_reporter=1", "num_workers=1 worker0_device=0",
                 "inputs=1 outputs=1", "in0 dims=4 bytes=12288 type=9",
                 "quant_type=1", "wrote 1 outputs", "async_equals_sync=1",
                 "callbacks=2", "callbacks_after_unset=2",
                 # the default config names the card; without one the
                 # engine refuses to start rather than serve on the host
                 "default_engine=0 default_workers=-1",
                 "unregistered=1 request_after_unregister_fails=1",
                 "C API OK"):
        assert line in out, (line, out)
    assert "c_api_ms_per_request=" in out
    got = np.fromfile(tmp_path / "out.0", np.int8).reshape(want[0].shape)
    np.testing.assert_array_equal(got, want[0])


def test_c_api_inline_config_and_quantization_getters(c_programs):
    """int8 model: affine quantization through the C ABI with the
    model's scale and zero point; the inline two-worker config."""
    _, exes, _, _ = c_programs
    path = os.path.join(DATA, "fc_int8.tflite")
    proc = _run(exes["main"], path)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "num_workers=2" in proc.stdout
    from band_tpu_torch.tflite.parser import parse_tflite_file

    g = parse_tflite_file(path)
    td = g.tensor(g.inputs[0])
    line = next(l for l in proc.stdout.splitlines()
                if l.startswith("quant num="))
    assert line == (
        f"quant num=1 scale0={float(td.quant.scale[0]):.6f} "
        f"zp0={int(td.quant.zero_point[0])} "
        f"dim={int(td.quant.quantized_dimension)}")


def test_c_api_error_surface(c_programs):
    _, exes, cfg, _ = c_programs
    proc = _run(exes["main"], "/nonexistent/model.tflite", cfg)
    assert proc.returncode == 1
    assert "register failed" in proc.stderr
    proc = _run(exes["main"], MODEL_PATH, "/nonexistent/config.json")
    assert proc.returncode == 1 and "config create failed" in proc.stderr


@pytest.mark.parametrize("fmt", [BufferFormat.RGB, BufferFormat.NV12])
def test_c_buffer_image_processor(c_programs, tmp_path, fmt):
    """buffer_main.c: the buffer + image-processor surface on the
    model's int8 input (automatic pipeline, crop, flip, rotate, NV21,
    strided I420, arity check), then a camera frame through
    BandImageProcessorProcess: the tensor byte-equal to the port's
    Python pipeline and within 1 code of band_tpu's; served byte-equal
    to TFLite on that tensor."""
    _, exes, cfg, _ = c_programs
    frame = camera_frame(31, 160, 120, fmt)
    (tmp_path / "frame.bin").write_bytes(frame_bytes(frame))
    proc = _run(exes["buffer_main"], MODEL_PATH, cfg, tmp_path / "frame.bin",
                160, 120, C_FORMAT[fmt], tmp_path / "tensor.bin",
                tmp_path / "out", 2)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    out = proc.stdout
    for line in ("auto left=100.0 right=120.0 ok=1", "crop=120.0 ok=1",
                 "flip=37.0 ok=1", "rotate=37.0 ok=1",
                 "nv21=-126.0 ok=1", "yuv=-126.0 ok=1", "sync ok=1",
                 "bad_arity=1", "BUFFER API OK"):
        assert line in out, (line, out)
    assert "c_buffer_ms_per_request=" in out
    shape = (1, 64, 64, 3)
    tensor = np.fromfile(tmp_path / "tensor.bin", np.int8).reshape(shape)
    mine = ImageProcessorBuilder().add_auto_convert(
        shape, np.int8).build().to_tensor(frame)
    np.testing.assert_array_equal(tensor, mine)
    planes = [p.data for p in frame.planes]
    jbuf = (jbuffer.Buffer.from_numpy(planes[0]) if len(planes) == 1 else
            jbuffer.Buffer.from_yuv(planes[0], planes[1], None,
                                    jbuffer.BufferFormat.NV12))
    theirs = jproc.ImageProcessorBuilder().add_auto_convert(
        shape, np.int8).build().to_tensor(jbuf)
    assert _bytes_within_one(tensor, theirs) <= 1
    served = np.fromfile(tmp_path / "out.0", np.int8).reshape(1, 10)
    np.testing.assert_array_equal(served, _tflite(MODEL_PATH, tensor))


def test_c_http_client_against_live_server(c_programs, tmp_path):
    """The plain-C HTTP client registers a model on a live port server
    and serves a golden input byte-equal to TFLite."""
    from band_tpu_torch.tools.server import serve

    _, exes, _, _ = c_programs
    xs, want = _goldens()
    xs[3].tofile(tmp_path / "in.bin")
    es, httpd = serve(_cfg(), port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        proc = _run(exes["http_client_main"], "127.0.0.1",
                    httpd.server_address[1], MODEL_PATH,
                    tmp_path / "in.bin", "int8", "1,64,64,3",
                    tmp_path / "out.bin")
        assert proc.returncode == 0, proc.stderr + proc.stdout
        assert "C HTTP CLIENT OK" in proc.stdout
    finally:
        httpd.shutdown()
        es.shutdown()
    got = np.fromfile(tmp_path / "out.bin", np.int8).reshape(want[3].shape)
    np.testing.assert_array_equal(got, want[3])
