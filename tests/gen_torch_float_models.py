"""Generator for the float32, fp16 and dynamic-range models of the
PyTorch port, and their goldens.

Models (``models``): the published MobileNetV2 1.0/224 (Sandler et al.
2018; keras.applications MobileNetV2, alpha=1.0, 224x224x3 input, 1000
classes) with random weights from seed 0 and batch-norm statistics set
from one uniform [-1, 1] batch, as tests/gen_mobilenet_v2_int8_model.py
builds it, converted twice with TFLite's post-training quantization:

  tests/data/mobilenet_v2_fp16.tflite      optimizations=[DEFAULT],
      supported_types=[float16]: weights stored float16 behind constant
      DEQUANTIZE ops (the parser folds them), float32 compute
  tests/data/mobilenet_v2_dynrange.tflite  optimizations=[DEFAULT], no
      representative set: weights of 1024 or more elements int8 per
      channel, float activations quantized per request at run time

Nothing is downloaded: ``weights=None``.  The generator prints each
model's op histogram and the count of hybrid ops (int8 weights, float
activations).

A float toy of the ops the port takes in float (``TOY_PATHS``, seed 7,
16x16x8 input): a stride-2 3x3 conv (asymmetric SAME padding), a
depthwise conv with depth multiplier 2, 1x1 convs and a 128-channel
depthwise conv, ADD, MUL, SUB, both pools, CONCATENATION, RELU, PAD,
RESIZE_BILINEAR, RELU6, MEAN, two FULLY_CONNECTED and SOFTMAX; written
in float32 and with dynamic-range quantization (the 3x3 conv, the 1x1
convs, the 128-channel depthwise conv and the first FC get int8
weights).

Goldens (``goldens``): tests/data/torch_float_goldens.npz holds, for
each model of MODELS, with ``REQUESTS`` inputs uniform in [-1, 1] from
``np.random.default_rng(seed)`` (``float_inputs``; the seeds are stored,
not the inputs):

  <name>/seed    the input seed
  <name>/tflite  [N, ...] the TFLite interpreter's outputs
                 (BUILTIN_WITHOUT_DEFAULT_DELEGATES)
  <name>/dev     [N] band_tpu's largest absolute deviation from them per
                 request (its CPU executor, conv_mode="f32_split")

Run: PYTHONPATH=. python tests/gen_torch_float_models.py [models|goldens]
(TF; goldens also jax; ~2 min)
"""

import os
import sys

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FP16_PATH = os.path.join(DATA, "mobilenet_v2_fp16.tflite")
DYNRANGE_PATH = os.path.join(DATA, "mobilenet_v2_dynrange.tflite")
FLOAT_GOLDENS_PATH = os.path.join(DATA, "torch_float_goldens.npz")
TOY_PATHS = {False: os.path.join(DATA, "float_toy.tflite"),
             True: os.path.join(DATA, "float_toy_dynrange.tflite")}
MODELS = {
    "mobilenet_v2_fp16": 1101,
    "mobilenet_v2_dynrange": 1102,
    "fp16_cnn": 1103,
    "dynrange": 1104,
}
REQUESTS = 8


def float_inputs(seed: int, shape, n: int = REQUESTS) -> np.ndarray:
    """n float32 request inputs of one model, uniform in [-1, 1]."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (n, *shape)).astype(np.float32)


def _mobilenet_v2():
    import tensorflow as tf

    tf.keras.utils.set_random_seed(0)
    model = tf.keras.applications.MobileNetV2(
        input_shape=(224, 224, 3), alpha=1.0, weights=None)
    rng = np.random.default_rng(0)
    calib = rng.uniform(-1.0, 1.0, (16, 224, 224, 3)).astype(np.float32)
    for layer in model.layers:
        if isinstance(layer, tf.keras.layers.BatchNormalization):
            layer.momentum = 0.0
    model(calib, training=True)  # moving statistics := this batch's
    return model


def histogram(path: str):
    """(op histogram, hybrid op count) of a model file, from the port's
    own parser: an op is hybrid when its activation input is float and
    its weight input an int8 constant."""
    from band_tpu_torch.tflite.parser import parse_tflite_file

    g = parse_tflite_file(path)
    hybrid = {}
    for op in g.ops:
        if len(op.inputs) < 2 or op.inputs[1] < 0:
            continue
        x, w = g.tensor(op.inputs[0]), g.tensor(op.inputs[1])
        if x.dtype.kind == "f" and w.is_constant and w.dtype == np.int8:
            hybrid[op.opname] = hybrid.get(op.opname, 0) + 1
    return g.op_histogram(), hybrid


def _float_toy():
    import tensorflow as tf

    L = tf.keras.layers
    tf.keras.utils.set_random_seed(7)
    x = L.Input((16, 16, 8), batch_size=1)
    a = L.Conv2D(16, 3, strides=2, padding="same", activation="relu6")(x)
    b = L.DepthwiseConv2D(3, depth_multiplier=2, padding="same",
                          activation="relu")(a)
    c = L.Conv2D(128, 1, activation="relu6")(b)
    d = L.DepthwiseConv2D(3, padding="same", activation="relu6")(c)
    e = L.Conv2D(32, 1)(d)
    f = L.Add()([e, b])
    h = L.Subtract()([L.Multiply()([f, b]), f])
    cat = L.Concatenate()([L.MaxPool2D(3, 2, "same")(h),
                           L.AveragePooling2D(3, 2, "same")(h)])
    u = L.UpSampling2D(2, interpolation="bilinear")(
        L.ZeroPadding2D(1)(L.ReLU()(cat)))
    m = L.GlobalAveragePooling2D()(L.ReLU(6.0)(u))
    out = L.Dense(10, activation="softmax")(
        L.Dense(64, activation="relu")(m))
    return tf.keras.Model(x, out)


def models() -> None:
    import tensorflow as tf

    model = _mobilenet_v2()
    toy = _float_toy()
    for path, net, opt, fp16 in ((FP16_PATH, model, True, True),
                                 (DYNRANGE_PATH, model, True, False),
                                 (TOY_PATHS[False], toy, False, False),
                                 (TOY_PATHS[True], toy, True, False)):
        conv = tf.lite.TFLiteConverter.from_keras_model(net)
        if opt:
            conv.optimizations = [tf.lite.Optimize.DEFAULT]
        if fp16:
            conv.target_spec.supported_types = [tf.float16]
        flat = conv.convert()
        with open(path, "wb") as f:
            f.write(flat)
        it = tf.lite.Interpreter(model_path=path)
        ops = [o["op_name"] for o in it._get_ops_details()]
        print("wrote", path, len(flat), "bytes")
        print("  file ops:", len(ops),
              {n: ops.count(n) for n in sorted(set(ops))})
        hist, hybrid = histogram(path)
        print("  parsed ops:", sum(hist.values()), dict(sorted(hist.items())))
        print("  hybrid ops:", sum(hybrid.values()), hybrid)


def tflite_outputs(path: str, xs: np.ndarray) -> np.ndarray:
    import tensorflow as tf

    it = tf.lite.Interpreter(
        model_path=path,
        experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType
            .BUILTIN_WITHOUT_DEFAULT_DELEGATES))
    it.allocate_tensors()
    (ind,) = it.get_input_details()
    (outd,) = it.get_output_details()
    outs = []
    for x in xs:
        it.set_tensor(ind["index"], x[None] if x.ndim < len(ind["shape"])
                      else x)
        it.invoke()
        outs.append(it.get_tensor(outd["index"]).copy())
    return np.stack(outs)


def band_tpu_outputs(path: str, xs: np.ndarray) -> np.ndarray:
    import jax

    from band_tpu.backend.program import build_program
    from band_tpu.tflite.parser import parse_tflite_file

    g = parse_tflite_file(path)
    prog = build_program(g, range(len(g.ops)), exact=True,
                         conv_mode="f32_split")
    fn = jax.jit(prog.make_fn())
    return np.stack([np.asarray(fn(prog.params, [x])[0]) for x in xs])


def goldens() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from band_tpu.tflite.parser import parse_tflite_file

    out = {}
    for name, seed in MODELS.items():
        path = os.path.join(DATA, f"{name}.tflite")
        g = parse_tflite_file(path)
        xs = float_inputs(seed, g.tensor(g.inputs[0]).shape)
        tfl = tflite_outputs(path, xs)
        ref = band_tpu_outputs(path, xs)
        dev = np.abs(ref.astype(np.float64) - tfl).reshape(len(xs), -1)
        out[f"{name}/seed"] = np.int64(seed)
        out[f"{name}/tflite"] = tfl
        out[f"{name}/dev"] = dev.max(axis=1)
        top1 = (ref.reshape(len(xs), -1).argmax(1)
                == tfl.reshape(len(xs), -1).argmax(1))
        print(name, "band_tpu deviation per request", out[f"{name}/dev"],
              "top-1 equal", top1.tolist())
    np.savez_compressed(FLOAT_GOLDENS_PATH, **out)
    print("wrote", FLOAT_GOLDENS_PATH, os.path.getsize(FLOAT_GOLDENS_PATH),
          "bytes")


if __name__ == "__main__":
    what = sys.argv[1:] or ["models", "goldens"]
    if "models" in what:
        models()
    if "goldens" in what:
        goldens()
