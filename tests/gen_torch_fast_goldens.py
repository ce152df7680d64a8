"""Generator for tests/data/torch_fast_goldens.npz — the fast-numerics
outputs (RuntimeConfig.numerics == "fast") that the PyTorch port must
give on the card, where there is no JAX to compare with.

For each model below, GOLDEN_REQUESTS inputs are drawn as
tests/gen_torch_goldens.py draws them (``golden_inputs``; the four CNNs
keep their seeds there, quant_act_int8 has its own).  Each model is cut
at its MEANs into MEAN-free segments (band_tpu's MEAN is not TFLite's,
ROADMAP C1, so the two packages can only be compared between MEANs).
Per request, the port's fast program runs the whole model on the CPU
(the kernels' plain versions) and keeps every activation; each segment,
fed the port's own activations, then runs through band_tpu's fast
program (conv_mode="f32_split", as tests/test_fast_numerics.py builds
it), and the generator asserts the port's segment outputs equal
band_tpu's byte for byte.  The file keeps, per model:

  <name>/seed            the input seed
  <name>/input_sha       sha256 of the regenerated inputs
  <name>/seg<i>/ops      [first op, last op + 1] of segment i
  <name>/seg<i>/out<j>   [N, ...]: band_tpu's fast output j of segment i
  <name>/fast_output<j>  [N, ...]: the port's fast model output j
and for quant_act_int8 also
  <name>/tflite_output<j> [N, ...]: the TFLite interpreter's (exact)
                          output j, builtin kernels
(model outputs j in the order of the model's outputs, as the engine
returns them; segment outputs in the program's order).

Run: python tests/gen_torch_fast_goldens.py   (writes tests/data/)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.gen_torch_goldens import (  # noqa: E402
    DATA, GOLDEN_REQUESTS, MODELS as EXACT_MODELS, golden_inputs, input_sha)

FAST_GOLDENS_PATH = os.path.join(DATA, "torch_fast_goldens.npz")
MODELS = dict(EXACT_MODELS, quant_act_int8=1004)
TFLITE_MODELS = ("quant_act_int8",)


def mean_free_segments(graph):
    """[first, last + 1) op ranges between the MEANs of ``graph``."""
    n = len(graph.ops)
    means = [op.index for op in graph.ops if op.opname == "MEAN"]
    cuts = [0] + [c for m in means for c in (m, m + 1)] + [n]
    return [(a, b) for a, b in zip(cuts[:-1], cuts[1:])
            if b > a and graph.ops[a].opname != "MEAN"]


def port_activations(graph, prog, x):
    """Every tensor of one run of the port's program ``prog`` (the whole
    model) on input ``x``: {tensor id: numpy array}."""
    import torch

    from band_tpu_torch.backend.program import params_from_jax
    from band_tpu_torch.ops.lowerings import LowerCtx
    from band_tpu_torch.ops.registry import get_lowering

    ctx = LowerCtx(graph, params_from_jax(prog.params), prog.meta)
    ctx.set(graph.inputs[0], torch.from_numpy(np.ascontiguousarray(x)))
    with torch.inference_mode():
        for op in graph.ops:
            get_lowering(op.opname).trace(ctx, op)
    return {t: v.numpy() for t, v in ctx.env.items()}


def compute():
    """The goldens as a dict of numpy arrays (asserts the port equals
    band_tpu on every segment while it builds them)."""
    import jax

    from band_tpu.backend.program import build_program as jbuild
    from band_tpu.tflite.parser import parse_tflite_file as jparse
    from band_tpu_torch.backend.program import build_program as tbuild
    from band_tpu_torch.tflite.parser import parse_tflite_file as tparse

    out = {}
    for name, seed in MODELS.items():
        path = os.path.join(DATA, f"{name}.tflite")
        tg, jg = tparse(path), jparse(path)
        td = tg.tensor(tg.inputs[0])
        xs = golden_inputs(seed, td.shape, td.dtype)
        out[f"{name}/seed"] = np.int64(seed)
        out[f"{name}/input_sha"] = np.array(input_sha(xs))
        whole = tbuild(tg, range(len(tg.ops)), exact=False)
        acts = [port_activations(tg, whole, x) for x in xs]
        # model outputs in the model's order, as the engine returns them
        for j, t in enumerate(tg.outputs):
            out[f"{name}/fast_output{j}"] = np.stack([a[t] for a in acts])
        for i, (a, b) in enumerate(mean_free_segments(tg)):
            seg = list(range(a, b))
            tprog = tbuild(tg, seg, exact=False)
            jprog = jbuild(jg, seg, exact=False, conv_mode="f32_split")
            assert tprog.output_ids == jprog.output_ids, (name, i)
            fn = jax.jit(jprog.make_fn())
            outs = [[] for _ in jprog.output_ids]
            for r, act in enumerate(acts):
                ins = [act[t] if t in act else xs[r] for t in jprog.input_ids]
                for j, (o, t) in enumerate(zip(fn(jprog.params, ins),
                                               jprog.output_ids)):
                    o = np.asarray(o)
                    np.testing.assert_array_equal(
                        act[t], o,
                        err_msg=f"{name} segment {a}-{b} request {r}")
                    outs[j].append(o)
            out[f"{name}/seg{i}/ops"] = np.array([a, b], np.int64)
            for j, o in enumerate(outs):
                out[f"{name}/seg{i}/out{j}"] = np.stack(o)
        if name in TFLITE_MODELS:
            for j, o in enumerate(tflite_outputs(path, xs)):
                out[f"{name}/tflite_output{j}"] = o
    return out


def tflite_outputs(path, xs):
    """The TFLite interpreter's outputs (builtin kernels) of each input,
    stacked per output."""
    import tensorflow as tf

    it = tf.lite.Interpreter(
        model_path=path,
        experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType
            .BUILTIN_WITHOUT_DEFAULT_DELEGATES),
    )
    it.allocate_tensors()
    (ind,) = it.get_input_details()
    from band_tpu_torch.tflite.parser import parse_tflite_file

    # the model's output tensors in the order the port returns them (the
    # port's tensor ids are the interpreter's tensor indices)
    order = parse_tflite_file(path).outputs
    outs = [[] for _ in order]
    for x in xs:
        it.set_tensor(ind["index"], x)
        it.invoke()
        for j, t in enumerate(order):
            outs[j].append(it.get_tensor(t).copy())
    return [np.stack(o) for o in outs]


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = compute()
    np.savez_compressed(FAST_GOLDENS_PATH, **out)
    print("wrote", FAST_GOLDENS_PATH, os.path.getsize(FAST_GOLDENS_PATH),
          "bytes;", GOLDEN_REQUESTS, "requests per model")


if __name__ == "__main__":
    main()
