"""Generator for tests/data/torch_frontend_goldens.npz — camera frames
through band_tpu's data plane, then the TFLite interpreter, for the
front-end slice of the PyTorch port (chip_smoke.py's frontend phase).

Eight 1920x1080 frames (``band_tpu_torch.buffer.synthetic.camera_frame``:
low-frequency cosines plus integer noise, from a seed), four RGB and four
NV12 as a camera delivers them, each run through band_tpu's
``ImageProcessorBuilder().add_auto_convert(...)`` to the full-width
MobileNetV2's input (int8 [1, 224, 224, 3]), then through TFLite with
builtin kernels (BUILTIN_WITHOUT_DEFAULT_DELEGATES), a fresh interpreter
per request.  The file keeps:

  seeds        [8]        the frame seeds (frames are regenerated)
  formats      [8]        "rgb" or "nv12"
  frame_sha    [8]        sha256 of each frame's planes, so a reader can
                          tell a changed frame stream from a changed
                          data plane
  tensors      [8, 1, 224, 224, 3] int8: band_tpu's AutoConvert output
  outputs      [8, 1, 1000] int8: TFLite's output on each tensor

Run: PYTHONPATH=. python tests/gen_torch_frontend_goldens.py
(needs TensorFlow and band_tpu; writes tests/data/)
"""

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDENS_PATH = os.path.join(DATA, "torch_frontend_goldens.npz")
MODEL = "mobilenet_v2_int8"
SEEDS = tuple(range(1300, 1308))
FORMATS = ("rgb",) * 4 + ("nv12",) * 4
WIDTH, HEIGHT = 1920, 1080


def frames():
    """(seed, format, band_tpu_torch Buffer) of every golden frame."""
    from band_tpu_torch.buffer.buffer import BufferFormat
    from band_tpu_torch.buffer.synthetic import camera_frame

    fmt = {"rgb": BufferFormat.RGB, "nv12": BufferFormat.NV12}
    return [(s, f, camera_frame(s, WIDTH, HEIGHT, fmt[f]))
            for s, f in zip(SEEDS, FORMATS)]


def band_tpu_tensor(buf, shape, dtype):
    """band_tpu's AutoConvert of a port Buffer (same planes, band_tpu's
    types)."""
    from band_tpu.buffer.buffer import Buffer, BufferFormat
    from band_tpu.buffer.processor import ImageProcessorBuilder

    planes = [p.data for p in buf.planes]
    if len(planes) == 1:
        jbuf = Buffer.from_numpy(planes[0], BufferFormat.RGB)
    else:
        jbuf = Buffer.from_yuv(planes[0], planes[1], None, BufferFormat.NV12)
    proc = ImageProcessorBuilder().add_auto_convert(shape, dtype).build()
    return proc.to_tensor(jbuf)


def main():
    import tensorflow as tf

    from band_tpu_torch.buffer.synthetic import frame_digest

    path = os.path.join(DATA, f"{MODEL}.tflite")

    def interpreter():
        it = tf.lite.Interpreter(
            model_path=path,
            experimental_op_resolver_type=(
                tf.lite.experimental.OpResolverType
                .BUILTIN_WITHOUT_DEFAULT_DELEGATES
            ),
        )
        it.allocate_tensors()
        return it

    d_in = interpreter().get_input_details()[0]
    shape = [int(s) for s in d_in["shape"]]
    tensors, outputs, shas = [], [], []
    for seed, fmt, buf in frames():
        x = band_tpu_tensor(buf, shape, d_in["dtype"])
        it = interpreter()
        it.set_tensor(d_in["index"], x)
        it.invoke()
        tensors.append(x)
        outputs.append(it.get_tensor(it.get_output_details()[0]["index"]))
        shas.append(frame_digest(buf))
        print(f"frame {seed} ({fmt}): top-1 {int(np.argmax(outputs[-1]))}")
    np.savez_compressed(
        GOLDENS_PATH,
        seeds=np.asarray(SEEDS, np.int64),
        formats=np.asarray(FORMATS),
        frame_sha=np.asarray(shas),
        tensors=np.stack(tensors),
        outputs=np.stack(outputs),
    )
    print(f"wrote {GOLDENS_PATH} ({os.path.getsize(GOLDENS_PATH)} bytes)")


if __name__ == "__main__":
    main()
