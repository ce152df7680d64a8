"""The port's int64 requantization (band_tpu_torch/ops/quant.py) against
band_tpu's 32-bit-limb version (band_tpu/ops/quant.py): the same inputs
from numpy, byte-equal outputs (tolerance 0) over the whole int32 range
of the accumulator, every shift TFLite's QuantizeMultiplier can give,
and all three roundings."""

import numpy as np
import pytest
import torch

import band_tpu.ops.quant as JQ
import band_tpu_torch.ops.quant as TQ
from band_tpu_torch.ops.kernels import lut_softmax_plain

SHIFTS = np.arange(-31, 31)
INT32 = np.iinfo(np.int32)


def _accumulators(rng, n):
    """Uniform int32 values plus the edges: 0, +-1, the extremes, and
    powers of two with their neighbours (where rounding ties live)."""
    edges = [0, 1, -1, INT32.min, INT32.max, INT32.min + 1, INT32.max - 1]
    for p in range(31):
        edges += [1 << p, -(1 << p), (1 << p) + 1, -(1 << p) - 1,
                  (1 << p) - 1, -(1 << p) + 1]
    edges = np.clip(np.array(edges, np.int64), INT32.min, INT32.max)
    rand = rng.integers(INT32.min, INT32.max, n, endpoint=True)
    small = rng.integers(-(1 << 16), 1 << 16, n)
    return np.concatenate([edges, rand, small]).astype(np.int32)


def _multipliers(rng, n):
    """TFLite multipliers lie in [2^30, 2^31); 0 for a zero scale."""
    qm = rng.integers(1 << 30, (1 << 31) - 1, n, endpoint=True)
    qm[:3] = [1 << 30, (1 << 31) - 1, 0]
    return qm.astype(np.int32)


@pytest.mark.parametrize("rounding", ["single", "double", "ruy"])
def test_multiply_by_quantized_multiplier_matches_band_tpu(rounding):
    rng = np.random.default_rng(1)
    x = _accumulators(rng, 3000)
    qm = _multipliers(rng, x.size)
    for shift in SHIFTS:
        sh = np.full(x.shape, shift, np.int32)
        want = np.asarray(JQ.multiply_by_quantized_multiplier(
            x, qm, sh, rounding))
        got = TQ.multiply_by_quantized_multiplier(
            torch.from_numpy(x), torch.from_numpy(qm), torch.from_numpy(sh),
            rounding).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"shift {shift}")


@pytest.mark.parametrize("rounding", ["single", "double", "ruy"])
def test_scalar_multipliers_match_tensor_multipliers(rounding):
    """A Python-int multiplier and shift (as ADD and MEAN pass them)
    give what the same values as tensors give."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_accumulators(rng, 500))
    for qm in (1 << 30, 1518500250, (1 << 31) - 1):
        for shift in SHIFTS:
            got = TQ.multiply_by_quantized_multiplier(x, qm, int(shift),
                                                      rounding)
            want = TQ.multiply_by_quantized_multiplier(
                x, torch.full_like(x, qm), torch.full_like(x, int(shift)),
                rounding)
            assert torch.equal(got, want), (qm, shift)


@pytest.mark.parametrize("rounding", ["single", "double", "ruy"])
@pytest.mark.parametrize("out_dtype", [np.int8, np.uint8])
def test_requantize_exact_matches_band_tpu(rounding, out_dtype):
    rng = np.random.default_rng(2)
    x = _accumulators(rng, 2000)
    qm = _multipliers(rng, x.size)
    # per-element shifts over the whole range, and a realistic band
    sh = rng.integers(-31, 31, x.size).astype(np.int32)
    info = np.iinfo(out_dtype)
    for out_zp, (qmin, qmax) in ((0, (info.min, info.max)),
                                 (-7 if out_dtype == np.int8 else 131,
                                  (info.min + 3, info.max - 5))):
        want = np.asarray(JQ.requantize_exact(
            x, qm, sh, out_zp, qmin, qmax, out_dtype, rounding))
        got = TQ.requantize_exact(
            torch.from_numpy(x), torch.from_numpy(qm), torch.from_numpy(sh),
            out_zp, qmin, qmax, out_dtype, rounding).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_quantize_multiplier_matches_band_tpu():
    rng = np.random.default_rng(3)
    ms = np.concatenate([
        10.0 ** rng.uniform(-12, 3, 5000),
        [0.0, 1.0, 0.5, 2.0 ** -31, 2.0 ** -32, 2.0 ** -40, 1 - 2 ** -40],
    ])
    jq, js = JQ.quantize_multipliers(ms)
    tq, ts = TQ.quantize_multipliers(ms)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("activation",
                         ["NONE", "RELU", "RELU6", "RELU_N1_TO_1"])
def test_activation_range_matches_band_tpu(activation):
    rng = np.random.default_rng(4)
    for _ in range(200):
        scale = float(10.0 ** rng.uniform(-3, 0))
        for dtype in (np.int8, np.uint8):
            info = np.iinfo(dtype)
            zp = int(rng.integers(info.min, info.max + 1))
            assert TQ.activation_range(activation, scale, zp, dtype) == \
                JQ.activation_range(activation, scale, zp, dtype)


def test_softmax_table_and_plain_softmax_match_band_tpu():
    rng = np.random.default_rng(5)
    for in_dtype, out_dtype, depth in ((np.int8, np.int8, 1000),
                                       (np.uint8, np.uint8, 10),
                                       (np.int8, np.int8, 37)):
        scale = float(10.0 ** rng.uniform(-2, 0))
        beta = float(rng.uniform(0.5, 2.0))
        table = TQ.softmax_table(scale, beta)
        np.testing.assert_array_equal(table, JQ.softmax_table(scale, beta))
        info = np.iinfo(in_dtype)
        x = rng.integers(info.min, info.max + 1, (3, 4, depth)).astype(
            in_dtype)
        out_zp = -128 if out_dtype == np.int8 else 0
        want = np.asarray(JQ.lut_softmax(x, table, 1.0 / 256, out_zp,
                                         out_dtype))
        got = lut_softmax_plain(torch.from_numpy(x), torch.from_numpy(table),
                                1.0 / 256, out_zp, out_dtype).numpy()
        np.testing.assert_array_equal(got, want)
