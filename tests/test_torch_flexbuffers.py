"""The port's FlexBuffers reader (band_tpu_torch/tflite/flexbuffers.py)
against the ``flatbuffers`` package's reference reader, and the custom-op
options of the SSD models against band_tpu's parser.  The port's parser
must decode them without the ``flatbuffers`` package, which a serving
machine may lack (the detection post-process would otherwise run on its
defaults and give other boxes); a payload it cannot decode, cut short
for one, refuses the model."""

import os
import random
import sys

import pytest
from flatbuffers import flexbuffers as ref

from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.errors import ModelError
from band_tpu_torch.tflite import flexbuffers
from band_tpu_torch.tflite import parser as tparser
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

VALUES = [0, 1, -1, 127, -128, 300, -70000, 2**40, -2**40, 0.5, 1e-3,
          0.1, True, False, None, "abc", "", b"\x00\x01\xff", [1, 2, 3],
          [1.5, 2.5], ["a", "bb"], [1, "x", 2.0, None, True],
          {"a": 1, "b": [1, 2]}, [True, False], [[1, 2], [3]],
          {"z": {"y": "x"}}]


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_scalar_and_nested_values(i):
    data = ref.Dumps(VALUES[i])
    assert flexbuffers.loads(data) == ref.Loads(data)


@pytest.mark.parametrize("seed", range(4))
def test_random_option_maps(seed):
    rng = random.Random(seed)
    for _ in range(100):
        m = {f"k{j}" * rng.randint(1, 3): rng.choice(VALUES)
             for j in range(rng.randint(0, 12))}
        data = ref.Dumps(m)
        assert flexbuffers.loads(data) == ref.Loads(data) == m


@pytest.mark.parametrize("elems,kind", [
    ([1, 2, 3], None), ([1.5, 2.5], ref.Type.FLOAT), ([-7, 8], ref.Type.INT)])
@pytest.mark.parametrize("fixed", [False, True])
def test_typed_vectors(elems, kind, fixed):
    b = ref.Builder()
    if fixed:
        b.FixedTypedVectorFromElements(elems, *(() if kind is None
                                                else (kind,)))
    else:
        b.TypedVectorFromElements(elems, *(() if kind is None else (kind,)))
    data = b.Finish()
    assert flexbuffers.loads(data) == ref.Loads(data)


@pytest.mark.parametrize("name", ["ssd_int8", "ssd_regular_int8"])
def test_ssd_options_without_the_flatbuffers_package(name, monkeypatch):
    path = os.path.join(DATA, f"{name}.tflite")
    want = next(op for op in jparse(path).ops if op.is_custom).options
    # importing flatbuffers fails from here on
    monkeypatch.setitem(sys.modules, "flatbuffers", None)
    monkeypatch.setitem(sys.modules, "flatbuffers.flexbuffers", None)
    got = next(op for op in tparse(path).ops if op.is_custom).options
    assert got == want
    assert got["nms_score_threshold"] == pytest.approx(0.35)


def _ssd_with_options_cut_to(tmp_path, keep):
    """ssd_int8.tflite with its custom op's options vector cut to its
    first ``keep`` bytes (the vector's length field rewritten)."""
    path = os.path.join(DATA, "ssd_int8.tflite")
    data = bytearray(open(path, "rb").read())
    seen = []
    orig = tparser._decode_custom_options
    try:
        tparser._decode_custom_options = lambda raw: (
            seen.append(bytes(raw)) or orig(raw))
        tparse(path)
    finally:
        tparser._decode_custom_options = orig
    (raw,) = seen
    at = data.find(raw)
    assert at > 0 and data.find(raw, at + 1) < 0
    assert int.from_bytes(data[at - 4:at], "little") == len(raw)
    data[at - 4:at] = keep.to_bytes(4, "little")
    out = tmp_path / "ssd_cut.tflite"
    out.write_bytes(bytes(data))
    return str(out), raw


@pytest.mark.parametrize("keep", [1, 2, 3, 64, 150, 301])
def test_truncated_custom_options_refuse_the_model(tmp_path, keep):
    path, raw = _ssd_with_options_cut_to(tmp_path, keep)
    assert keep < len(raw)
    with pytest.raises(ModelError, match="custom-op options"):
        tparse(path)


def test_every_truncation_of_the_ssd_options_is_refused(tmp_path):
    _, raw = _ssd_with_options_cut_to(tmp_path, 1)
    assert tparser._decode_custom_options(raw)["max_detections"] == 10
    for k in range(1, len(raw)):
        with pytest.raises(ModelError):
            tparser._decode_custom_options(raw[:k])
