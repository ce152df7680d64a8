"""The plain reference against TFLite's committed outputs, byte for
byte (tests/data/torch_goldens.npz, tests/data/torch_ops_goldens.npz)."""

import hashlib
import os

import numpy as np
import pytest
import torch

from portbench.reference import kernels as K
from portbench.reference.interp import Reference
from portbench.reference.tflite import read_model
from portbench.tests.conftest import ROOT

DATA = os.path.join(ROOT, "tests", "data")


def golden_inputs(seed, shape, n):
    """The golden generators' requests: uniform int8 from the seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, size=(n, *shape),
                        dtype=np.int64).astype(np.int8)


def test_mobilenet_v2_equals_tflite():
    z = np.load(os.path.join(DATA, "torch_goldens.npz"))
    want = z["mobilenet_v2_int8/output"]
    xs = golden_inputs(int(z["mobilenet_v2_int8/seed"]), (1, 224, 224, 3),
                       len(want))
    ref = Reference(read_model(os.path.join(DATA, "mobilenet_v2_int8.tflite")))
    got = ref(xs[:, 0])[0]
    assert got.shape == (len(want), 1000)
    assert np.array_equal(got, want[:, 0])


def test_fsrcnn_small_equals_tflite():
    z = np.load(os.path.join(DATA, "torch_ops_goldens.npz"))
    want = z["fsrcnn_x2_small_int8/exact0"]
    xs = golden_inputs(int(z["fsrcnn_x2_small_int8/seed"]), (1, 24, 40, 1),
                       len(want))
    ref = Reference(read_model(os.path.join(DATA,
                                            "fsrcnn_x2_small_int8.tflite")))
    assert np.array_equal(ref(xs[:, 0])[0], want[:, 0])


@pytest.mark.parametrize("frame", [0, 5])
def test_fsrcnn_full_width_matches_tflite_digest(frame):
    z = np.load(os.path.join(DATA, "torch_ops_goldens.npz"))
    xs = golden_inputs(int(z["fsrcnn_x2_int8/seed"]), (1, 360, 640, 1), 8)
    ref = Reference(read_model(os.path.join(DATA, "fsrcnn_x2_int8.tflite")))
    out = ref(xs[frame])[0]
    assert out.shape == (1, 720, 1280, 1)
    digest = hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest()
    assert digest == str(z["fsrcnn_x2_int8/exact_sha"][frame])


def _mbqm(x, qm, shift, rounding):
    return int(K.mbqm(torch.tensor([x]), qm, shift, rounding)[0])


@pytest.mark.parametrize("x, shift, single, double, ruy", [
    (5, -1, 1, 2, 2),  # 1.25: double rounding reads 2.5 -> 3, then 1.5 -> 2
    (-3, 0, -1, -1, -1),  # -1.5: the high multiply's nudge goes toward 0
    (3, 0, 2, 2, 2),  # 1.5
    (-10, -2, -1, -1, -1),  # -1.25
    (-20, -2, -2, -3, -2),  # -2.5: the shift rounds away from 0 in double
])
def test_roundings_by_hand(x, shift, single, double, ruy):
    q = 1 << 30  # the multiplier 0.5 at shift 0
    got = [_mbqm(x, q, shift, r) for r in ("single", "double", "ruy")]
    assert got == [single, double, ruy]


def test_quantize_multiplier():
    assert K.quantize_multiplier(0.5) == (1 << 30, 0)
    assert K.quantize_multiplier(1.0) == (1 << 30, 1)
    q, s = K.quantize_multiplier(0.0123)
    assert (1 << 30) <= q < (1 << 31)
    assert abs(q * 2.0 ** (s - 31) - 0.0123) < 1e-9


def test_reference_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    z = np.load(os.path.join(DATA, "torch_goldens.npz"))
    xs = golden_inputs(int(z["mobilenet_v2_int8/seed"]), (1, 224, 224, 3), 8)
    model = read_model(os.path.join(DATA, "mobilenet_v2_int8.tflite"))
    got = Reference(model, device="cuda")(xs[:, 0])[0]
    assert np.array_equal(got, z["mobilenet_v2_int8/output"][:, 0])
