"""Generator for the sequence models of the PyTorch port, and their
goldens.

Models (``models``): the Keras example "Bidirectional LSTM on IMDB"
(keras.io/examples/nlp/bidirectional_lstm_imdb): max_features 20,000,
maxlen 200, Embedding 128, Bidirectional(LSTM(64, return_sequences=True)),
Bidirectional(LSTM(64)), Dense(1, sigmoid), batch 1, nothing cut; random
weights from ``SEED`` (Keras's default initializers).  Each model has two
outputs: the sigmoid and the first BiLSTM's sequence [1, 200, 128] (with
random weights the sigmoid sits near 0.5 and alone would test little).
It is converted twice from the same weights:

  imdb_bilstm.tflite        through tf_keras (Keras 2): GATHER, four
      UNIDIRECTIONAL_SEQUENCE_LSTM, REVERSE_V2, CONCATENATION, ...
  imdb_bilstm_while.tflite  through Keras 3, the tf_keras model's
      weights copied in: four WHILE loops over body and cond subgraphs
      (FULLY_CONNECTED on the state, GATHER, SPLIT, the TensorArray write)

The two files are about 11 MB each, mostly the same 20,000 x 128
embedding table, so they are stored together as ``ARCHIVE``
(tests/data/imdb_bilstm.tar.xz, 9.6 MB: xz keeps one copy of the
table); ``extract()`` unpacks them (chip_smoke.py does the same).

The same script writes, in tests/data:

  imdb_bilstm_small{,_while}.tflite  the same network with T=6, a
      vocabulary of 50 and width 4 (Embedding 4, LSTM(4)), both
      conversions (seed SEED + 1)
  while_data_dep.tflite  a WHILE whose trip count depends on the
      request's data: v = |x|, i = 0; while sum(v) < 40: i += 1,
      v = v * 1.5 + 0.1; outputs (i, v), x [1, 8]

Goldens (``goldens``): tests/data/torch_seq_goldens.npz, for both
full-width models and ``REQUESTS`` reviews of 40-200 token ids in [1,
20000) from ``np.random.default_rng(GOLDEN_SEED)``, pre-padded with 0 to
200 as the example's pad_sequences does (``reviews``):

  xs                 [N, 1, 200] int32 the token ids
  <name>/tflite/<k>  [N, ...] TFLite's output k (the graph's output
                     order), a FRESH interpreter for each request: the
                     interpreter's LSTM keeps its h and c variable
                     tensors from one invoke() to the next
  <name>/band/<k>    [N, ...] band_tpu's output k (its CPU program,
                     conv_mode="f32_split")

and for tests/data/lstm_seq_int8.tflite (the int8 LSTM the card serves
with its int8 Dense head on kernels B1 and B4):

  lstm_seq_int8/xs      [N, 1, 12, 16] int8, uniform over the codes
                        (``np.random.default_rng(INT8_SEED)``)
  lstm_seq_int8/tflite  [N, 1, 10] int8 TFLite's output, a fresh
                        interpreter for each request

Run: PYTHONPATH=. python tests/gen_torch_seq_models.py [models|goldens]
(TF, tf_keras; goldens also jax; ~2 min)
"""

import io
import os
import sys
import tarfile

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ARCHIVE = os.path.join(DATA, "imdb_bilstm.tar.xz")
FULL = ("imdb_bilstm", "imdb_bilstm_while")
SMALL = ("imdb_bilstm_small", "imdb_bilstm_small_while")
DATA_DEP = "while_data_dep"
GOLDENS = os.path.join(DATA, "torch_seq_goldens.npz")
SEED = 12
GOLDEN_SEED = 1212
INT8 = "lstm_seq_int8"
INT8_SEED = 1213
REQUESTS = 8
MAX_FEATURES, MAXLEN, EMBED, UNITS = 20000, 200, 128, 64
SMALL_DIMS = (50, 6, 4, 4)  # vocabulary, T, embedding, LSTM units


def extract(dest):
    """Unpack the full-width models into ``dest``; their paths."""
    os.makedirs(dest, exist_ok=True)
    paths = [os.path.join(dest, f"{n}.tflite") for n in FULL]
    if not all(os.path.exists(p) for p in paths):
        with tarfile.open(ARCHIVE, "r:xz") as tar:
            tar.extractall(dest, filter="data")
    return dict(zip(FULL, paths))


def reviews(n, seed=GOLDEN_SEED, vocab=MAX_FEATURES, maxlen=MAXLEN,
            shortest=40):
    """n reviews of shortest..maxlen token ids in [1, vocab), pre-padded
    with 0 to maxlen: [n, 1, maxlen] int32."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 1, maxlen), np.int32)
    for k in range(n):
        length = int(rng.integers(shortest, maxlen + 1))
        out[k, 0, maxlen - length:] = rng.integers(1, vocab, length)
    return out


def _build(keras, vocab, maxlen, embed, units):
    inp = keras.Input(shape=(maxlen,), batch_size=1, dtype="int32")
    x = keras.layers.Embedding(vocab, embed)(inp)
    seq = keras.layers.Bidirectional(
        keras.layers.LSTM(units, return_sequences=True))(x)
    x = keras.layers.Bidirectional(keras.layers.LSTM(units))(seq)
    out = keras.layers.Dense(1, activation="sigmoid")(x)
    return keras.Model(inp, [out, seq])


def _pair(seed, vocab, maxlen, embed, units):
    """(fused, while) .tflite bytes of one build: tf_keras's random
    weights, copied into the Keras 3 model."""
    import tensorflow as tf
    import tf_keras

    tf_keras.utils.set_random_seed(seed)
    m2 = _build(tf_keras, vocab, maxlen, embed, units)
    m3 = _build(tf.keras, vocab, maxlen, embed, units)
    m3.set_weights(m2.get_weights())
    ids = reviews(2, seed, vocab, maxlen, maxlen // 5)[:, 0]
    for a, b in zip(m2.predict(ids, batch_size=1, verbose=0),
                    m3.predict(ids, batch_size=1, verbose=0)):
        assert np.allclose(a, b, atol=1e-5), "the weight copy failed"
    return [tf.lite.TFLiteConverter.from_keras_model(m).convert()
            for m in (m2, m3)]


def _data_dependent_while():
    import tensorflow as tf

    class M(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec([1, 8], tf.float32)])
        def f(self, x):
            def cond(i, v):
                return tf.reduce_sum(v) < 40.0

            def body(i, v):
                return i + 1, v * 1.5 + 0.1

            return tf.while_loop(cond, body, [tf.constant(0), tf.abs(x)])

    m = M()
    return tf.lite.TFLiteConverter.from_concrete_functions(
        [m.f.get_concrete_function()], m).convert()


def _write(name, data):
    path = os.path.join(DATA, f"{name}.tflite")
    with open(path, "wb") as f:
        f.write(data)
    print(f"wrote {path} ({len(data)} bytes)")


def models():
    for name, data in zip(SMALL, _pair(SEED + 1, *SMALL_DIMS)):
        _write(name, data)
    _write(DATA_DEP, _data_dependent_while())
    full = _pair(SEED, MAX_FEATURES, MAXLEN, EMBED, UNITS)
    with tarfile.open(ARCHIVE, "w:xz", preset=9) as tar:
        for name, data in zip(FULL, full):
            info = tarfile.TarInfo(f"{name}.tflite")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
            print(f"{name}.tflite: {len(data)} bytes")
    print(f"wrote {ARCHIVE} ({os.path.getsize(ARCHIVE)} bytes)")


def goldens():
    import jax

    from band_tpu.backend.program import build_program
    from band_tpu.tflite.parser import parse_tflite_file
    from tests.conftest import make_tfl_interpreter

    paths = extract(os.path.join(os.path.dirname(DATA), "..",
                                 "band_tpu_torch", "_build", "data"))
    xs = reviews(REQUESTS)
    out = {"xs": xs}
    for name, path in paths.items():
        g = parse_tflite_file(path)
        prog = build_program(g, range(len(g.ops)), exact=True,
                             conv_mode="f32_split")
        fn = jax.jit(prog.make_fn())
        pos = [prog.output_ids.index(t) for t in g.outputs]
        tfl = [[] for _ in g.outputs]
        band = [[] for _ in g.outputs]
        for x in xs:
            it = make_tfl_interpreter(path)  # fresh: the LSTM keeps state
            it.allocate_tensors()
            it.set_tensor(g.inputs[0], x)
            it.invoke()
            outs = fn(prog.params, [x])
            for k, t in enumerate(g.outputs):
                tfl[k].append(np.array(it.get_tensor(t)))
                band[k].append(np.asarray(outs[pos[k]]))
        for k in range(len(g.outputs)):
            out[f"{name}/tflite/{k}"] = np.concatenate(tfl[k])
            out[f"{name}/band/{k}"] = np.concatenate(band[k])
            d = np.abs(out[f"{name}/band/{k}"].astype(np.float64)
                       - out[f"{name}/tflite/{k}"]).max()
            print(f"{name} output {k}: band_tpu's largest deviation from "
                  f"TFLite {d:.3e}")
    path = os.path.join(DATA, f"{INT8}.tflite")
    g = parse_tflite_file(path)
    rng = np.random.default_rng(INT8_SEED)
    x8 = rng.integers(-128, 128, (REQUESTS,) + tuple(
        g.tensor(g.inputs[0]).shape)).astype(np.int8)
    want = []
    for x in x8:
        it = make_tfl_interpreter(path)
        it.allocate_tensors()
        it.set_tensor(g.inputs[0], x)
        it.invoke()
        want.append(np.array(it.get_tensor(g.outputs[0])))
    out[f"{INT8}/xs"] = x8
    out[f"{INT8}/tflite"] = np.stack(want)
    np.savez_compressed(GOLDENS, **out)
    print(f"wrote {GOLDENS} ({os.path.getsize(GOLDENS)} bytes)")


if __name__ == "__main__":
    what = sys.argv[1:] or ["models", "goldens"]
    if "models" in what:
        models()
    if "goldens" in what:
        goldens()
