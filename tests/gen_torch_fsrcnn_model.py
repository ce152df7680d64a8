"""Generator for tests/data/fsrcnn_x2_int8.tflite and
tests/data/fsrcnn_x2_small_int8.tflite: FSRCNN(d=56, s=12, m=4), x2.

The published deconvolution super-resolution network (Dong, Loy and
Tang, "Accelerating the Super-Resolution Convolutional Neural Network",
ECCV 2016, arXiv:1608.00367, section 3.2 and Fig. 2) at its published
widths:

  feature extraction  conv 5x5, 1 -> 56, PReLU
  shrinking           conv 1x1, 56 -> 12, PReLU
  mapping             4 x conv 3x3, 12 -> 12, PReLU
  expanding           conv 1x1, 12 -> 56, PReLU
  deconvolution       deconv 9x9, 56 -> 1, stride 2

on a Y plane: the full model takes the 360x640 low-resolution frame of
720p and gives 720x1280; the small one takes 24x40 (the same widths, for
the CPU tests).  Weights are random from SEED (He-uniform), every bias
random and nonzero (so the deconv carries a bias input), the PReLU
slopes per channel uniform in 0.25 +- 0.1 (the paper's initial value).
Full-integer post-training quantization (int8 in and out, per-channel
weights), calibrated on seeded smooth random frames, with the converter
settings of tests/gen_tconv_model.py.  The converter keeps its
SHAPE -> STRIDED_SLICE -> PACK prelude of the deconv's output shape.

Run: python tests/gen_torch_fsrcnn_model.py   (writes tests/data/, ~1 min)
"""

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEED = 2016
D, S, M = 56, 12, 4
SIZES = {
    "fsrcnn_x2_int8": (360, 640),
    "fsrcnn_x2_small_int8": (24, 40),
}
CALIBRATION_FRAMES = 8


def build(h, w, rng):
    import tensorflow as tf

    def init(shape):
        fan_in = int(np.prod(shape[:-1]))
        lim = np.sqrt(6.0 / fan_in)
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    def conv(x, k, cout, name):
        cin = x.shape[-1]
        layer = tf.keras.layers.Conv2D(cout, k, padding="same", name=name)
        y = layer(x)
        layer.set_weights([init((k, k, cin, cout)),
                           rng.uniform(-0.1, 0.1, cout).astype(np.float32)])
        prelu = tf.keras.layers.PReLU(shared_axes=[1, 2],
                                      name=f"{name}_prelu")
        y = prelu(y)
        prelu.set_weights([rng.uniform(0.15, 0.35, (1, 1, cout))
                           .astype(np.float32)])
        return y

    inp = tf.keras.Input((h, w, 1))
    x = conv(inp, 5, D, "feature")
    x = conv(x, 1, S, "shrink")
    for i in range(M):
        x = conv(x, 3, S, f"map{i}")
    x = conv(x, 1, D, "expand")
    deconv = tf.keras.layers.Conv2DTranspose(1, 9, strides=2, padding="same",
                                             name="deconv")
    y = deconv(x)
    # Conv2DTranspose kernels are [k, k, cout, cin]
    deconv.set_weights([init((9, 9, 1, D)) * 0.5,
                        rng.uniform(0.05, 0.1, 1).astype(np.float32)])
    return tf.keras.Model(inp, y)


def frames(rng, n, h, w):
    """Smooth random frames in [0, 1]: bilinear upsampling of 1/8-size
    noise plus a little fine noise."""
    import tensorflow as tf

    coarse = rng.uniform(0, 1, (n, max(h // 8, 2), max(w // 8, 2), 1))
    up = tf.image.resize(coarse.astype(np.float32), (h, w)).numpy()
    fine = rng.normal(0, 0.05, (n, h, w, 1))
    return np.clip(up + fine, 0, 1).astype(np.float32)


def convert(name, h, w):
    import tensorflow as tf

    rng = np.random.default_rng(SEED)  # same weights at every size
    model = build(h, w, rng)
    cal = frames(np.random.default_rng(SEED + 1), CALIBRATION_FRAMES, h, w)

    def rep():
        for f in cal:
            yield [f[None]]

    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = rep
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.int8
    conv.inference_output_type = tf.int8
    flat = conv.convert()
    path = os.path.join(DATA, f"{name}.tflite")
    with open(path, "wb") as f:
        f.write(flat)
    print("wrote", path, len(flat), "bytes")


def main():
    os.makedirs(DATA, exist_ok=True)
    for name, (h, w) in SIZES.items():
        convert(name, h, w)


if __name__ == "__main__":
    main()
