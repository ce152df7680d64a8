"""Generator for tests/data/torch_hetero_goldens.npz — goldens of the SSD
models the port serves across a GPU worker and a host worker.

For each SSD model below, REQUESTS float32 images are drawn from numpy's
PCG64 with the model's seed (standard normal, as tests/test_ssd_detection.py
draws them; regenerated, not stored) and run through the TFLite
interpreter with its builtin kernels (BUILTIN_WITHOUT_DEFAULT_DELEGATES,
the exactness oracle), every tensor preserved.  The detection
post-process is a custom op: the port runs band_tpu's numpy version of it
(ops/host_ops.py, a verbatim copy), whose box decode differs from
TFLite's C++ kernel in the last bit of some box corners.  So the file
keeps, per model:

  <name>/seed         the input seed
  <name>/input_sha    sha256 of the regenerated inputs
  <name>/head         [N, ...] the custom op's first input from TFLite
                      (the int8 backbone's dequantized output)
  <name>/output<k>    [N, ...] output k (boxes, classes, scores, count) of
                      band_tpu's host op on TFLite's head inputs: what a
                      served request must give, byte for byte
  <name>/tflite<k>    [N, ...] output k of the TFLite interpreter itself

and checks, before writing, that classes, scores and counts are
byte-equal between the two and that boxes agree within BOX_ATOL.

Run: PYTHONPATH=. python tests/gen_torch_hetero_goldens.py   (tensorflow
and band_tpu; writes tests/data/)
"""

import hashlib
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
HETERO_GOLDENS_PATH = os.path.join(DATA, "torch_hetero_goldens.npz")
MODELS = {"ssd_int8": 2000, "ssd_regular_int8": 2001}
REQUESTS = 8
IMAGE_SHAPE = (1, 32, 32, 3)
POST = "CUSTOM:TFLite_Detection_PostProcess"
# TFLite's box decode against the numpy one: a few float32 ulps
BOX_ATOL = 1e-6


def hetero_inputs(seed: int, n: int = REQUESTS) -> np.ndarray:
    """n request images of one SSD model: [n, 1, 32, 32, 3] float32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, *IMAGE_SHAPE)).astype(np.float32)


def input_sha(xs: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(xs).tobytes()).hexdigest()


def main():
    import tensorflow as tf

    from band_tpu.ops.host_ops import run_host_op
    from band_tpu.tflite.parser import parse_tflite_file

    out = {}
    for name, seed in MODELS.items():
        path = os.path.join(DATA, f"{name}.tflite")
        g = parse_tflite_file(path)
        post = next(op for op in g.ops if op.opname == POST)
        it = tf.lite.Interpreter(
            model_path=path,
            experimental_op_resolver_type=(
                tf.lite.experimental.OpResolverType
                .BUILTIN_WITHOUT_DEFAULT_DELEGATES),
            experimental_preserve_all_tensors=True,
        )
        it.allocate_tensors()
        xs = hetero_inputs(seed)
        heads, ours, theirs = [], [], []
        for x in xs:
            it.set_tensor(it.get_input_details()[0]["index"], x)
            it.invoke()
            ins = [np.array(it.get_tensor(t)) for t in post.inputs if t >= 0]
            heads.append(ins[0])
            ours.append(run_host_op(POST, g, post, ins))
            theirs.append([np.array(it.get_tensor(d["index"]))
                           for d in it.get_output_details()])
        out[f"{name}/seed"] = np.asarray(seed)
        out[f"{name}/input_sha"] = np.asarray(input_sha(xs))
        out[f"{name}/head"] = np.stack(heads)
        for k in range(len(ours[0])):
            a = np.stack([o[k] for o in ours])
            b = np.stack([t[k] for t in theirs])
            if k == 0:
                np.testing.assert_allclose(a, b, rtol=0, atol=BOX_ATOL)
            else:
                np.testing.assert_array_equal(a, b)
            out[f"{name}/output{k}"] = a
            out[f"{name}/tflite{k}"] = b
        n = out[f"{name}/output3"][:, 0]
        print(f"{name}: {REQUESTS} requests, detections per request "
              f"{n.astype(int).tolist()}, boxes within "
              f"{np.abs(out[f'{name}/output0'] - out[f'{name}/tflite0']).max():.3g}"
              " of TFLite's")
    np.savez_compressed(HETERO_GOLDENS_PATH, **out)
    print("wrote", HETERO_GOLDENS_PATH)


if __name__ == "__main__":
    main()
