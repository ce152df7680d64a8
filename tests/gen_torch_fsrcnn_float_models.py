"""Generator for FSRCNN x2 in float32 and with dynamic-range quantization,
and for its goldens (the srfloat phase of chip_smoke.py).

Models (``models``): the network of tests/gen_torch_fsrcnn_model.py,
FSRCNN(d=56, s=12, m=4) x2 (arXiv:1608.00367 section 3.2) with the same
weights (SEED), converted twice without a calibration set:

  fsrcnn_x2_float.tflite      the default converter: float32 weights and
                              compute
  fsrcnn_x2_dynrange.tflite   optimizations=[DEFAULT]: weights of 1024 or
                              more elements int8 (the 5x5 and 3x3 convs
                              and the 9x9 deconv: hybrid ops whose float
                              input is quantized per request at run time),
                              the two 1x1 convs keep float32 weights

at 360x640 (the Y plane of 720p, 720x1280 out), and their 24x40 twins
``fsrcnn_x2_small_{float,dynrange}.tflite`` for the CPU tests.

Inputs (``sr_inputs``): smooth seeded frames in [0, 1] made with numpy
alone (the card's machine has no TensorFlow): 1/8-size uniform noise
upsampled bilinearly, plus uniform fine noise.

Goldens (``goldens``): tests/data/torch_srfloat_goldens.npz holds, for
each full-width model and its REQUESTS requests:

  positions        [POSITIONS] int32 flat indices into a 720x1280 output
                   (seeded, shared by both models)
  <name>/seed      the input seed (sr_inputs)
  <name>/tflite    [REQUESTS, POSITIONS] the TFLite interpreter's outputs
                   there (BUILTIN_WITHOUT_DEFAULT_DELEGATES)
  <name>/max       [REQUESTS] max|TFLite output| over the whole frame
  <name>/dev       [REQUESTS] the reference deviation over the positions:
                   band_tpu's (conv_mode="f32_split") for the float32
                   model; the port's CPU path's for the dynamic-range one,
                   whose TRANSPOSE_CONV band_tpu computes wrong (fault C9
                   in ROADMAP.md)

Run: PYTHONPATH=. python tests/gen_torch_fsrcnn_float_models.py
[models|goldens]   (TF; goldens also jax and torch; ~2 min)
"""

import importlib.util
import os
import sys

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SRFLOAT_GOLDENS_PATH = os.path.join(DATA, "torch_srfloat_goldens.npz")
SIZES = {"fsrcnn_x2": (360, 640), "fsrcnn_x2_small": (24, 40)}
FORMATS = ("float", "dynrange")
FULL = ("fsrcnn_x2_float", "fsrcnn_x2_dynrange")
SEEDS = {"fsrcnn_x2_float": 1501, "fsrcnn_x2_dynrange": 1502,
         "fsrcnn_x2_small_float": 1503, "fsrcnn_x2_small_dynrange": 1504}
POSITIONS_SEED = 1505
REQUESTS = 4
POSITIONS = 16384


def _fsrcnn():
    """tests/gen_torch_fsrcnn_model.py, loaded by path (tests is no
    package where this runs as a script)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gen_torch_fsrcnn_model.py")
    spec = importlib.util.spec_from_file_location("gen_fsrcnn", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_of(name: str) -> str:
    return os.path.join(DATA, f"{name}.tflite")


def _upsample(a: np.ndarray, size: int, axis: int) -> np.ndarray:
    """Bilinear resampling of ``axis`` to ``size`` samples (half-pixel
    centres, edges clamped), in float64."""
    n = a.shape[axis]
    src = np.clip((np.arange(size) + 0.5) * n / size - 0.5, 0, n - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    f = (src - lo).reshape([-1 if d == axis else 1 for d in range(a.ndim)])
    return np.take(a, lo, axis) * (1 - f) + np.take(a, hi, axis) * f


def sr_inputs(seed: int, n: int, h: int, w: int) -> np.ndarray:
    """n smooth float32 frames [n, h, w, 1] in [0, 1], numpy only."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0.0, 1.0, (n, max(h // 8, 2), max(w // 8, 2), 1))
    up = _upsample(_upsample(coarse, h, 1), w, 2)
    fine = rng.uniform(-0.08, 0.08, (n, h, w, 1))
    return np.clip(up + fine, 0.0, 1.0).astype(np.float32)


def positions() -> np.ndarray:
    """POSITIONS distinct flat indices into a 720x1280 output."""
    rng = np.random.default_rng(POSITIONS_SEED)
    return np.sort(rng.permutation(720 * 1280)[:POSITIONS]).astype(np.int32)


def models() -> None:
    import tensorflow as tf

    gen = _fsrcnn()
    os.makedirs(DATA, exist_ok=True)
    for base, (h, w) in SIZES.items():
        for fmt in FORMATS:
            model = gen.build(h, w, np.random.default_rng(gen.SEED))
            conv = tf.lite.TFLiteConverter.from_keras_model(model)
            if fmt == "dynrange":
                conv.optimizations = [tf.lite.Optimize.DEFAULT]
            flat = conv.convert()
            path = path_of(f"{base}_{fmt}")
            with open(path, "wb") as f:
                f.write(flat)
            print("wrote", path, len(flat), "bytes")


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
        it.set_tensor(ind["index"], x[None])
        it.invoke()
        outs.append(it.get_tensor(outd["index"]).copy())
    return np.concatenate(outs)


def band_tpu_outputs(path: str, xs: np.ndarray) -> np.ndarray:
    import jax

    from band_tpu.backend.program import build_program
    from band_tpu.tflite.parser import parse_tflite_file

    g = parse_tflite_file(path)
    prog = build_program(g, range(len(g.ops)), exact=True,
                         conv_mode="f32_split")
    fn = jax.jit(prog.make_fn())
    return np.concatenate([np.asarray(fn(prog.params, [x[None]])[0])
                           for x in xs])


def port_outputs(path: str, xs: np.ndarray) -> np.ndarray:
    """The port's CPU path (every kernel's plain version), one request at
    a time."""
    import torch

    from band_tpu_torch.backend.program import build_program
    from band_tpu_torch.tflite.parser import parse_tflite_file

    g = parse_tflite_file(path)
    prog = build_program(g, range(len(g.ops)))
    params = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in prog.params.items()}
    fn = prog.make_fn()
    with torch.inference_mode():
        return np.concatenate([fn(params, [torch.from_numpy(x[None])])[0]
                               .numpy() for x in xs])


def goldens() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    pos = positions()
    out = {"positions": pos}
    for name in FULL:
        h, w = SIZES["fsrcnn_x2"]
        xs = sr_inputs(SEEDS[name], REQUESTS, h, w)
        tfl = tflite_outputs(path_of(name), xs).reshape(REQUESTS, -1)
        ref = (band_tpu_outputs if name.endswith("float") else
               port_outputs)(path_of(name), xs).reshape(REQUESTS, -1)
        dev = np.abs(ref[:, pos].astype(np.float64) - tfl[:, pos])
        out[f"{name}/seed"] = np.int64(SEEDS[name])
        out[f"{name}/tflite"] = tfl[:, pos]
        out[f"{name}/max"] = np.abs(tfl).max(axis=1)
        out[f"{name}/dev"] = dev.max(axis=1)
        print(name, "max|golden|", out[f"{name}/max"], "reference deviation",
              out[f"{name}/dev"])
    np.savez_compressed(SRFLOAT_GOLDENS_PATH, **out)
    print("wrote", SRFLOAT_GOLDENS_PATH,
          os.path.getsize(SRFLOAT_GOLDENS_PATH), "bytes")


if __name__ == "__main__":
    what = sys.argv[1:] or ["models", "goldens"]
    if "models" in what:
        models()
    if "goldens" in what:
        goldens()
