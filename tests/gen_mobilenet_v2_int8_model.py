"""Generator for tests/data/mobilenet_v2_int8.tflite — the published
MobileNetV2 1.0/224 architecture (Sandler et al. 2018; keras.applications
MobileNetV2, alpha=1.0, 224x224x3 input, 1000 classes) with random
weights from a fixed seed, full-int8 post-training quantized with a seeded
random representative set (int8 inputs and outputs, as
gen_effnet_model.py does).  Nothing is downloaded: ``weights=None``.

Before conversion the batch-norm statistics are set from one batch of
the same random inputs (one forward pass in training mode with momentum
0).  With Keras' default initialisation and identity statistics the
activations shrink layer by layer until the 1000 logits are one value
for every input; with calibrated statistics every layer sees unit-scale
activations and the logits vary with the input (~160 distinct int8
values per image), so an output comparison tests the whole depth.

The graph has 65 ops: 35 CONV_2D, 17 DEPTHWISE_CONV_2D, 10 ADD, 1 MEAN,
1 FULLY_CONNECTED and 1 SOFTMAX, at the published widths (16..1280
channels, 112^2..7^2 activations).

Run: python tests/gen_mobilenet_v2_int8_model.py   (writes tests/data/)
"""

import os

import numpy as np
import tensorflow as tf

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "mobilenet_v2_int8.tflite")


def main():
    tf.keras.utils.set_random_seed(0)
    model = tf.keras.applications.MobileNetV2(
        input_shape=(224, 224, 3), alpha=1.0, weights=None
    )
    rng = np.random.default_rng(0)
    calib = rng.uniform(-1.0, 1.0, (16, 224, 224, 3)).astype(np.float32)
    bns = [layer for layer in model.layers
           if isinstance(layer, tf.keras.layers.BatchNormalization)]
    for layer in bns:
        layer.momentum = 0.0
    model(calib, training=True)  # moving statistics := this batch's

    def rep():
        for _ in range(8):
            yield [rng.uniform(-1.0, 1.0, (1, 224, 224, 3)).astype(np.float32)]

    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.representative_dataset = rep
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.int8
    conv.inference_output_type = tf.int8
    flat = conv.convert()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "wb") as f:
        f.write(flat)
    print("wrote", OUT, len(flat), "bytes")

    it = tf.lite.Interpreter(model_path=OUT)
    ops = [o["op_name"] for o in it._get_ops_details()]
    print("ops:", len(ops), {name: ops.count(name) for name in sorted(set(ops))})


if __name__ == "__main__":
    main()
