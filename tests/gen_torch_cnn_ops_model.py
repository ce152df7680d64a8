"""Generator for tests/data/cnn_ops_int8.tflite: a toy int8 model of the
structural and activation ops that decoders and super-resolution and
segmentation heads emit around their convs (pads, slices, splits,
concatenations with per-input requant, depth/space moves, resizes,
RELU/RELU6/LEAKY_RELU, transpose convs of 12 output channels) and the float unary table (EXP, LOG, SQRT, RSQRT,
SQUARE, ABS, NEG, SIN, COS, FLOOR, CEIL, ROUND, HARD_SWISH), each
as the converter lowers it: int8 where TFLite has an int8 kernel, else
float between a DEQUANTIZE and a QUANTIZE.  (GELU is left out: the
converter decomposes the tanh form and refuses the erf form.)

Weights and calibration data are random from SEED; full-integer
post-training quantization (int8 in and out), float builtins allowed
for the ops without an int8 kernel.

Run: python tests/gen_torch_cnn_ops_model.py   (writes tests/data/)
"""

import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "cnn_ops_int8.tflite")
SEED = 77
SHAPE = (1, 12, 12, 4)


def build():
    import tensorflow as tf

    rng = np.random.default_rng(SEED)
    w1 = tf.constant(rng.normal(0, 0.4, (3, 3, 4, 8)).astype(np.float32))
    b1 = tf.constant(rng.uniform(-0.2, 0.2, 8).astype(np.float32))
    w2 = tf.constant(rng.normal(0, 0.3, (1, 1, 8, 8)).astype(np.float32))
    # transpose convs with 12 output channels: TFLite rounds channels 0-7
    # and 8-11 differently (ROADMAP fault C3)
    wt1 = tf.constant(rng.normal(0, 0.3, (3, 3, 12, 8)).astype(np.float32))
    wt2 = tf.constant(rng.normal(0, 0.3, (3, 3, 12, 8)).astype(np.float32))
    bt = tf.constant(rng.uniform(-0.2, 0.2, 12).astype(np.float32))

    class CnnOps(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec(SHAPE, tf.float32)])
        def f(self, x):
            c = tf.nn.conv2d(x, w1, 1, "SAME") + b1          # [1,12,12,8]
            d = tf.nn.conv2d(c, w2, 1, "SAME")               # another scale
            o = {}
            o["pad"] = tf.pad(c, [[0, 0], [1, 2], [2, 0], [0, 0]])
            o["padv2"] = tf.pad(d, [[0, 0], [1, 1], [0, 1], [0, 0]],
                                constant_values=0.5)
            o["mirror_reflect"] = tf.pad(c, [[0, 0], [2, 1], [1, 2], [0, 0]],
                                         mode="REFLECT")
            o["mirror_symmetric"] = tf.pad(d, [[0, 0], [1, 1], [2, 2],
                                               [0, 0]], mode="SYMMETRIC")
            o["slice"] = tf.slice(c, [0, 2, 1, 0], [1, 6, 8, 8])
            o["strided_slice"] = c[:, 1:11:2, ::3, 2:7]
            halves = tf.split(c, 2, axis=3)
            o["split"] = halves[1]
            parts = tf.split(d, [3, 5], axis=3)
            o["split_v"] = parts[0]
            o["concat"] = tf.concat([tf.nn.relu6(c), halves[0], parts[1]],
                                    axis=3)
            o["d2s"] = tf.nn.depth_to_space(c, 2)
            o["s2d"] = tf.nn.space_to_depth(d, 2)
            o["resize_nearest"] = tf.image.resize(c, [24, 24], "nearest")
            o["resize_nearest_ac"] = tf.compat.v1.image.resize_nearest_neighbor(
                d, [17, 17], align_corners=True)
            o["resize_bilinear"] = tf.image.resize(d, [20, 20], "bilinear")
            o["resize_bilinear_ac"] = tf.compat.v1.image.resize_bilinear(
                c, [23, 23], align_corners=True)
            o["squeeze"] = tf.squeeze(tf.expand_dims(d, 1), [1])
            o["tconv_even"] = tf.nn.conv2d_transpose(
                c, wt1, [1, 24, 24, 12], 2, "SAME") + bt
            o["tconv_odd"] = tf.nn.conv2d_transpose(
                d, wt2, [1, 25, 25, 12], 2, "VALID") + bt
            o["relu"] = tf.nn.relu(c + d)
            o["relu6"] = tf.nn.relu6(c * 3.0)
            o["leaky_relu"] = tf.nn.leaky_relu(d, alpha=0.2)
            o["exp"] = tf.exp(d * 0.5)
            o["log"] = tf.math.log(tf.abs(c) + 0.5)
            o["sqrt"] = tf.sqrt(tf.abs(d) + 0.1)
            o["rsqrt"] = tf.math.rsqrt(tf.abs(c) + 0.5)
            o["square"] = tf.square(d)
            o["abs"] = tf.abs(c - 0.3)
            o["neg"] = tf.negative(d)
            o["sin"] = tf.sin(c)
            o["cos"] = tf.cos(d)
            o["floor"] = tf.floor(c * 2.0)
            o["ceil"] = tf.math.ceil(d * 2.0)
            o["round"] = tf.round(c * 2.0)
            o["hard_swish"] = c * tf.nn.relu6(c + 3.0) * (1.0 / 6.0)
            return o

    return CnnOps()


def main():
    import tensorflow as tf

    m = build()
    rng = np.random.default_rng(SEED + 1)

    def rep():
        for _ in range(16):
            yield [rng.uniform(-1, 1, SHAPE).astype(np.float32)]

    conv = tf.lite.TFLiteConverter.from_concrete_functions(
        [m.f.get_concrete_function()], m)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = rep
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8,
                                      tf.lite.OpsSet.TFLITE_BUILTINS]
    conv.inference_input_type = tf.int8
    conv.inference_output_type = tf.int8
    flat = conv.convert()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "wb") as f:
        f.write(flat)
    print("wrote", OUT, len(flat), "bytes")


if __name__ == "__main__":
    main()
