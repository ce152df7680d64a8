"""Generator for the CenterNet detectors of the PyTorch port, and their
goldens.

Models (``models``), full-int8 post-training quantization with int8
input and output (8 representative images uniform in [-1, 1], seed 11):

  tests/data/centernet_mnv2_fpn_int8.tflite  CenterNet MobileNetV2 FPN
      512x512 (the TF2 Detection Zoo's TFLite-ready CenterNet; Zhou, Wang
      and Kraehenbuehl, "Objects as Points", arXiv:1904.07850):
      - backbone: keras.applications MobileNetV2(alpha=1.0,
        include_top=False, weights=None) at 512x512x3, random weights
        from seed 0, batch-norm statistics set from one uniform [-1, 1]
        batch (as tests/gen_torch_float_models.py builds it);
      - FPN: the top (out_relu, 16x16x1280) to 64 channels by a 1x1
        conv, then three top-down steps with filters 64, 32 and 24 over
        the skips block_9_add (32x32x64), block_5_add (64x64x32) and
        block_2_add (128x128x24): a nearest 2x UpSampling2D, plus a 1x1
        conv of the skip to the step's filters, ADD, then a 3x3 conv +
        BN + ReLU to 32, 24 and 24 filters; the output 128x128x24, stride
        4;
      - heads: each a 3x3 conv 24 -> 256 + ReLU, then a 1x1 conv to 90
        classes (sigmoid, bias -2.19 as in the paper), 2 (box size) and 2
        (center offset);
      - decode (the paper's section 4), in the graph: a 3x3 max pool
        (stride 1, SAME) of the heatmap, EQUAL and SELECT_V2 keep the
        peaks and zero the rest, RESHAPE to [1, 128*128*90], TOPK_V2 with
        k = 100, class = index mod 90, position = index div 90, y =
        position div 128, x = position mod 128, PACK [0, y, x] and
        GATHER_ND the size and offset at each peak; boxes 4 * (center +-
        size / 2);
      - outputs: boxes [1, 100, 4] (int8), scores [1, 100] (int8),
        classes [1, 100] (int32).
  tests/data/centernet_small_int8.tflite  the CPU-sized sibling: the same
      FPN, heads and decode with 8 classes, k = 20 and head width 32, the
      backbone replaced by five strided 3x3 convs (16, 24, 32, 64, 128
      filters) whose outputs 2-5 are the skips and the top, at 64x64x3.
  tests/data/compare_int8.tflite  the decode's quantized comparison
      alone: EQUAL and GREATER of two int8 inputs [1, 256] whose scales
      (representative range [0, 0.3], seed 0) differ in the fifth digit
      and are below 1/256, where TFLite's integer rescale maps two codes
      to one value.

Nothing is downloaded: ``weights=None``.  The generator prints each
model's op histogram, its size and its MACs a request.

Goldens (``goldens``): tests/data/torch_detect_goldens.npz holds, for
each model, ``REQUESTS`` int8 inputs uniform over [-128, 127] from
``np.random.default_rng(seed)`` (the seed and the inputs' sha256 are
stored, not the inputs) and per output j:

  <name>/seed, <name>/input_sha
  <name>/exact<j>  [N, ...] the TFLite interpreter's outputs
                   (BUILTIN_WITHOUT_DEFAULT_DELEGATES: XNNPACK rounds
                   otherwise)
  <name>/fast<j>   [N, ...] band_tpu's fast-numerics outputs (its CPU
                   executor, conv_mode="f32_split")

Run: PYTHONPATH=. python tests/gen_torch_centernet_model.py
[models|goldens] (TF; goldens also jax; both by default, ~3 min)
"""

import hashlib
import os
import sys

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDENS_PATH = os.path.join(DATA, "torch_detect_goldens.npz")
FULL = "centernet_mnv2_fpn_int8"
SMALL = "centernet_small_int8"
# name -> (input side, classes, k, head width, input seed)
CONFIGS = {
    FULL: (512, 90, 100, 256, 1201),
    SMALL: (64, 8, 20, 32, 1202),
}
FPN_FILTERS = (64, 32, 24)
FPN_OUT = (32, 24, 24)
HEAT_BIAS = -2.19
REQUESTS = 8


def path_of(name: str) -> str:
    return os.path.join(DATA, f"{name}.tflite")


def inputs(seed: int, shape, n: int = REQUESTS) -> np.ndarray:
    """n int8 request inputs, uniform over [-128, 127]."""
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, size=(n, *shape),
                        dtype=np.int64).astype(np.int8)


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _set_bn_stats(model, calib):
    import tensorflow as tf

    for layer in model.layers:
        if isinstance(layer, tf.keras.layers.BatchNormalization):
            layer.momentum = 0.0
    model(calib, training=True)  # moving statistics := this batch's


def _decode(heat, size, offset, classes, k):
    """Paper section 4: peaks by a 3x3 max pool, the top k over every
    class and position, size and offset gathered at each peak."""
    import tensorflow as tf

    _, h, w, _ = heat.shape
    pooled = tf.nn.max_pool2d(heat, 3, 1, "SAME")
    peaks = tf.where(tf.equal(heat, pooled), heat, tf.zeros_like(heat))
    scores, idx = tf.math.top_k(tf.reshape(peaks, [1, h * w * classes]), k)
    cls = tf.math.floormod(idx, classes)
    pos = tf.math.floordiv(idx, classes)
    y, x = tf.math.floordiv(pos, w), tf.math.floormod(pos, w)
    at = tf.stack([tf.zeros([1, k], tf.int32), y, x], axis=-1)
    wh = tf.gather_nd(size, at)
    off = tf.gather_nd(offset, at)
    cy = tf.cast(y, tf.float32) + off[..., 0]
    cx = tf.cast(x, tf.float32) + off[..., 1]
    hh, hw = wh[..., 0] * 0.5, wh[..., 1] * 0.5
    boxes = 4.0 * tf.stack([cy - hh, cx - hw, cy + hh, cx + hw], axis=-1)
    return boxes, scores, cls


def _fpn_and_heads(skips, top, classes, k, head):
    import tensorflow as tf

    L = tf.keras.layers
    x = L.Conv2D(FPN_FILTERS[0], 1)(top)
    for skip, f, nxt in zip(skips, FPN_FILTERS, FPN_OUT):
        x = L.UpSampling2D(2, interpolation="nearest")(x)
        x = L.Add()([x, L.Conv2D(f, 1)(skip)])
        x = L.Conv2D(nxt, 3, padding="same", use_bias=False)(x)
        x = L.ReLU()(L.BatchNormalization()(x))

    def branch(n, act=None, bias=0.0):
        y = L.Conv2D(head, 3, padding="same", activation="relu")(x)
        return L.Conv2D(n, 1, activation=act, bias_initializer=tf.keras.
                        initializers.Constant(bias))(y)

    return branch(classes, "sigmoid", HEAT_BIAS), branch(2), branch(2)


def build(name: str):
    """The network up to the heads (a keras model: heatmap, size,
    offset), its batch-norm statistics set."""
    import tensorflow as tf

    side, classes, k, head, _ = CONFIGS[name]
    tf.keras.utils.set_random_seed(0)
    L = tf.keras.layers
    inp = L.Input((side, side, 3), batch_size=1)
    if name == FULL:
        mnv2 = tf.keras.applications.MobileNetV2(
            input_shape=(side, side, 3), alpha=1.0, include_top=False,
            weights=None)
        taps = tf.keras.Model(mnv2.input, [
            mnv2.get_layer(n).output
            for n in ("block_9_add", "block_5_add", "block_2_add",
                      "out_relu")])
        s9, s5, s2, top = taps(inp)
        skips = (s9, s5, s2)
    else:
        levels, x = [], inp
        for f in (16, 24, 32, 64, 128):
            x = L.Conv2D(f, 3, strides=2, padding="same",
                         activation="relu")(x)
            levels.append(x)
        skips, top = (levels[3], levels[2], levels[1]), levels[4]
    model = tf.keras.Model(inp, _fpn_and_heads(skips, top, classes, k,
                                               head))
    rng = np.random.default_rng(0)
    calib = rng.uniform(-1.0, 1.0, (4, side, side, 3)).astype(np.float32)
    _set_bn_stats(model, calib)
    return model


def convert(name: str) -> bytes:
    """The network and its decode as one int8 TFLite graph."""
    import tensorflow as tf

    model = build(name)
    side, classes, k, *_ = CONFIGS[name]

    class Detector(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec([1, side, side, 3], tf.float32)])
        def detect(self, x):
            heat, size, offset = model(x)
            return _decode(heat, size, offset, classes, k)

    det = Detector()
    rng = np.random.default_rng(11)
    reps = rng.uniform(-1.0, 1.0, (8, 1, side, side, 3)).astype(np.float32)

    def rep():
        for r in reps:
            yield [r]

    conv = tf.lite.TFLiteConverter.from_concrete_functions(
        [det.detect.get_concrete_function()], det)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = rep
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.int8
    conv.inference_output_type = tf.int8
    return conv.convert()


def macs(path: str) -> int:
    """Multiply-accumulates of one request: every CONV_2D,
    DEPTHWISE_CONV_2D and FULLY_CONNECTED, from the port's parser."""
    from band_tpu_torch.tflite.parser import parse_tflite_file

    g = parse_tflite_file(path)
    total = 0
    for op in g.ops:
        if op.opname not in ("CONV_2D", "DEPTHWISE_CONV_2D",
                             "FULLY_CONNECTED"):
            continue
        out = g.tensor(op.outputs[0]).shape
        w = g.tensor(op.inputs[1]).shape
        if op.opname == "CONV_2D":
            total += int(np.prod(out)) * int(np.prod(w[1:]))
        elif op.opname == "DEPTHWISE_CONV_2D":
            total += int(np.prod(out)) * int(w[1]) * int(w[2])
        else:
            total += int(np.prod(out)) * int(w[1])
    return total


def compare_model() -> bytes:
    import tensorflow as tf

    class Compare(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec([1, 256], tf.float32),
                                      tf.TensorSpec([1, 256], tf.float32)])
        def f(self, a, b):
            return {"eq": tf.equal(a, b), "gt": tf.greater(a, b)}

    m = Compare()
    rng = np.random.default_rng(0)

    def rep():
        for _ in range(8):
            yield [rng.uniform(0, 0.3, (1, 256)).astype(np.float32)
                   for _ in range(2)]

    conv = tf.lite.TFLiteConverter.from_concrete_functions(
        [m.f.get_concrete_function()], m)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = rep
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.int8
    return conv.convert()


def models() -> None:
    from band_tpu_torch.tflite.parser import parse_tflite_file

    with open(path_of("compare_int8"), "wb") as f:
        f.write(compare_model())
    for name in CONFIGS:
        data = convert(name)
        with open(path_of(name), "wb") as f:
            f.write(data)
        g = parse_tflite_file(path_of(name))
        print(f"wrote {path_of(name)} ({len(data)} bytes, "
              f"{macs(path_of(name)) / 1e9:.3f} GMAC a request)")
        print(f"  ops {len(g.ops)}: {dict(sorted(g.op_histogram().items()))}")


def goldens() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from band_tpu.backend.program import build_program
    from band_tpu.tflite.parser import parse_tflite_file
    from tests.conftest import make_tfl_interpreter

    out = {}
    for name, (side, *_, seed) in CONFIGS.items():
        xs = inputs(seed, (1, side, side, 3))
        out[f"{name}/seed"] = np.int64(seed)
        out[f"{name}/input_sha"] = np.array(sha256(xs))
        it = make_tfl_interpreter(path_of(name))
        it.allocate_tensors()
        ind = it.get_input_details()[0]["index"]
        outd = it.get_output_details()
        g = parse_tflite_file(path_of(name))
        order = [next(d["index"] for d in outd if d["index"] == t)
                 for t in g.outputs]
        exact = [[] for _ in order]
        for x in xs:
            it.set_tensor(ind, x)
            it.invoke()
            for j, t in enumerate(order):
                exact[j].append(np.array(it.get_tensor(t)))
        prog = build_program(g, range(len(g.ops)), exact=False,
                             conv_mode="f32_split")
        fn = jax.jit(prog.make_fn())
        pos = [prog.output_ids.index(t) for t in g.outputs]
        fast = [[] for _ in order]
        for x in xs:
            res = fn(prog.params, [x])
            for j, p in enumerate(pos):
                fast[j].append(np.asarray(res[p]))
        for j in range(len(order)):
            out[f"{name}/exact{j}"] = np.stack(exact[j])
            out[f"{name}/fast{j}"] = np.stack(fast[j])
            same = int((out[f"{name}/exact{j}"] != out[f"{name}/fast{j}"])
                       .sum())
            print(f"{name} output {j} {out[f'{name}/exact{j}'].shape} "
                  f"{out[f'{name}/exact{j}'].dtype}: fast differs from "
                  f"exact in {same} values")
    np.savez_compressed(GOLDENS_PATH, **out)
    print(f"wrote {GOLDENS_PATH}")


def main(argv) -> None:
    what = argv[1:] or ["models", "goldens"]
    if "models" in what:
        models()
    if "goldens" in what:
        goldens()


if __name__ == "__main__":
    main(sys.argv)
