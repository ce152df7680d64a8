"""Generator for tests/data/torch_ops_goldens.npz: what the PyTorch port
must give on the int8 decoder and attention models.

Inputs come from ``golden_inputs`` (numpy's PCG64 seeded per model, so
they are regenerated rather than stored).  Per model of SMALL the file
keeps, for each output i:

  <name>/seed, <name>/input_sha   the input seed and the inputs' sha256
  <name>/exact<i>   [N, ...] the exact-numerics golden: the TFLite
                    interpreter's output (BUILTIN_WITHOUT_DEFAULT_DELEGATES),
                    or in cnn_ops_int8 band_tpu's exact output where the
                    output depends on a float fallback op (FLOAT_FALLBACK)
                    or is float32 (a slice of a DEQUANTIZE: band_tpu's and
                    the port's (q - zp) * s differ from TFLite's in the
                    last bit)
  <name>/tol<i>     the quant units the port may differ from it: 0; 1
                    for those float-fallback outputs (against band_tpu);
                    2 for attention_int8 (band_tpu's own bound against
                    TFLite, tests/test_model_families.py:59)
  <name>/fast<i>    [N, ...] band_tpu's fast-numerics output (FAST only)

For the full-width FSRCNN (FULL, 360x640 in, 720x1280 out) only the
sha256 of each request's output bytes is kept, so the file stays small:

  <name>/exact_sha [N]   TFLite's outputs
  <name>/fast_sha  [N]   band_tpu's fast outputs

Run: PYTHONPATH=. python tests/gen_torch_ops_goldens.py   (TF + jax, ~2 min)
"""

import hashlib
import os

import numpy as np

from tests.gen_torch_goldens import golden_inputs, input_sha

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
OPS_GOLDENS_PATH = os.path.join(DATA, "torch_ops_goldens.npz")
SMALL = {
    "fsrcnn_x2_small_int8": 1010,
    "tconv_int8": 1011,
    "cnn_ops_int8": 1012,
    "attention_int8": 1013,
}
FAST = ("fsrcnn_x2_small_int8", "tconv_int8")
FULL = {"fsrcnn_x2_int8": 1014}
REQUESTS = 8
FULL_REQUESTS = 8
# ops band_tpu computes through a float32 fallback (dequantize, float op,
# quantize) where TFLite has an integer kernel
FLOAT_FALLBACK = {
    "RESIZE_BILINEAR", "BATCH_MATMUL", "SQUARED_DIFFERENCE", "EXP", "LOG",
    "SQRT", "RSQRT", "SQUARE", "ABS", "NEG", "SIN", "COS", "FLOOR", "CEIL",
    "ROUND", "GELU", "HARD_SWISH"}
ATTENTION_TOL = 2


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def float_fallback_outputs(graph):
    """Output positions of ``graph`` that depend on a FLOAT_FALLBACK op."""
    producer = {t: op for op in graph.ops for t in op.outputs}
    memo = {}

    def tainted(t):
        if t not in memo:
            op = producer.get(t)
            memo[t] = op is not None and (
                op.opname in FLOAT_FALLBACK
                or any(tainted(i) for i in op.inputs if i >= 0))
        return memo[t]

    return [i for i, t in enumerate(graph.outputs) if tainted(t)]


def tflite_outputs(path, xs):
    import tensorflow as tf

    it = tf.lite.Interpreter(
        model_path=path,
        experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType
            .BUILTIN_WITHOUT_DEFAULT_DELEGATES))
    it.allocate_tensors()
    (ind,) = it.get_input_details()
    # in the graph's output order
    order = [d["index"] for d in it.get_output_details()]
    outs = []
    for x in xs:
        it.set_tensor(ind["index"], x)
        it.invoke()
        outs.append([it.get_tensor(t).copy() for t in order])
    return order, [np.stack(o) for o in zip(*outs)]


def band_tpu_outputs(graph, xs, exact):
    import jax

    from band_tpu.backend.program import build_program

    prog = build_program(graph, range(len(graph.ops)), exact=exact,
                         conv_mode="f32_split")
    fn = jax.jit(prog.make_fn())
    pos = [list(prog.output_ids).index(t) for t in graph.outputs]
    outs = [fn(prog.params, [x]) for x in xs]
    return [np.stack([np.asarray(o[p]) for o in outs]) for p in pos]


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from band_tpu.tflite.parser import parse_tflite_file

    out = {}
    for name, seed in {**SMALL, **FULL}.items():
        path = os.path.join(DATA, f"{name}.tflite")
        g = parse_tflite_file(path)
        td = g.tensor(g.inputs[0])
        n = FULL_REQUESTS if name in FULL else REQUESTS
        xs = golden_inputs(seed, td.shape, td.dtype, n)
        out[f"{name}/seed"] = np.int64(seed)
        out[f"{name}/input_sha"] = np.array(input_sha(xs))
        order, tfl = tflite_outputs(path, xs)
        assert order == list(g.outputs), name
        if name in FULL:
            out[f"{name}/exact_sha"] = np.array([sha(o) for o in tfl[0]])
            (fast,) = band_tpu_outputs(g, xs, exact=False)
            out[f"{name}/fast_sha"] = np.array([sha(o) for o in fast])
            print(name, "exact and fast digests of", n, "requests")
            continue
        want = list(tfl)
        tol = [ATTENTION_TOL if name == "attention_int8" else 0] * len(want)
        if name == "cnn_ops_int8":
            exact = band_tpu_outputs(g, xs, exact=True)
            for i in float_fallback_outputs(g):
                want[i], tol[i] = exact[i], 1
            for i, t in enumerate(g.outputs):
                if g.tensor(t).dtype.kind == "f":
                    want[i] = exact[i]
        for i, (w, t) in enumerate(zip(want, tol)):
            out[f"{name}/exact{i}"] = w
            out[f"{name}/tol{i}"] = np.int64(t)
        if name in FAST:
            for i, f in enumerate(band_tpu_outputs(g, xs, exact=False)):
                out[f"{name}/fast{i}"] = f
        print(name, len(want), "outputs, tolerances", tol)
    np.savez_compressed(OPS_GOLDENS_PATH, **out)
    print("wrote", OPS_GOLDENS_PATH, os.path.getsize(OPS_GOLDENS_PATH),
          "bytes")


if __name__ == "__main__":
    main()
