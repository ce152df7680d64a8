"""Generator for tests/data/torch_goldens.npz — the TFLite interpreter's
outputs for the int8 CNNs that the PyTorch port serves end to end.

For each model below, GOLDEN_REQUESTS inputs are drawn from
``golden_inputs`` (numpy's PCG64 seeded with the model's seed, so the
inputs are regenerated rather than stored) and run through the TFLite
interpreter with its builtin kernels (BUILTIN_WITHOUT_DEFAULT_DELEGATES,
the exactness oracle).  The file keeps, per model:

  <name>/seed        the input seed
  <name>/input_sha   sha256 of the regenerated inputs, so a reader can
                     tell a changed input stream from a changed model
  <name>/output      [N, *output shape]: the model output of each input
  <name>/logits_tid  tensor id of the last op's input (SOFTMAX's logits)
  <name>/logits      [N, *logits shape]: that tensor for each input

The logits are kept beside the output because a 1000-class int8 softmax
of a randomly initialised network is nearly flat: comparing the logits
tests every layer below it.

Run: python tests/gen_torch_goldens.py   (writes tests/data/)
"""

import hashlib
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDENS_PATH = os.path.join(DATA, "torch_goldens.npz")
MODELS = {
    "mobilenet_v2_int8": 1000,
    "effnetlite_int8": 1001,
    "resnetish_int8": 1002,
    "fc_int8": 1003,
}
GOLDEN_REQUESTS = 8


def golden_inputs(seed: int, shape, dtype, n: int = GOLDEN_REQUESTS):
    """n request inputs of one model: uniform over the dtype's range."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    return rng.integers(info.min, info.max + 1, size=(n, *shape),
                        dtype=np.int64).astype(dtype)


def input_sha(xs: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(xs).tobytes()).hexdigest()


def main():
    import tensorflow as tf

    out = {}
    for name, seed in MODELS.items():
        path = os.path.join(DATA, f"{name}.tflite")
        it = tf.lite.Interpreter(
            model_path=path,
            experimental_op_resolver_type=(
                tf.lite.experimental.OpResolverType
                .BUILTIN_WITHOUT_DEFAULT_DELEGATES),
            experimental_preserve_all_tensors=True,
        )
        it.allocate_tensors()
        (ind,) = it.get_input_details()
        (outd,) = it.get_output_details()
        logits_tid = int(it._get_ops_details()[-1]["inputs"][0])
        xs = golden_inputs(seed, tuple(ind["shape"]), ind["dtype"])
        outs, logits = [], []
        for x in xs:
            it.set_tensor(ind["index"], x)
            it.invoke()
            outs.append(it.get_tensor(outd["index"]).copy())
            logits.append(it.get_tensor(logits_tid).copy())
        out[f"{name}/seed"] = np.int64(seed)
        out[f"{name}/input_sha"] = np.array(input_sha(xs))
        out[f"{name}/output"] = np.stack(outs)
        out[f"{name}/logits_tid"] = np.int64(logits_tid)
        out[f"{name}/logits"] = np.stack(logits)
        print(name, "inputs", xs.shape, "logits distinct",
              len(np.unique(out[f"{name}/logits"])))
    np.savez_compressed(GOLDENS_PATH, **out)
    print("wrote", GOLDENS_PATH, os.path.getsize(GOLDENS_PATH), "bytes")


if __name__ == "__main__":
    main()
