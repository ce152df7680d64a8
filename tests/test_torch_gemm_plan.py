"""The int8 GEMM's launch plan (``gemm_plan``: block tile and K split per
shape) and the exactness of its split-K reduction, on the CPU.

The CUDA kernel (csrc/qmatmul.cu) splits K over the blocks of a cluster
and adds their int32 partials modulo 2^32.  Here that reduction is
reproduced in numpy for every split count the plan can give, with a bias
near +-2^31 so that the sums wrap, and held byte-equal to the plain
version and to band_tpu's Pallas kernels (interpret mode).  The kernel
itself is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from band_tpu.ops import quant as JQ
from band_tpu.ops.pallas.qmatmul import qmatmul as pallas_qmatmul
from band_tpu.ops.pallas.qmatmul import qmatmul_exact as pallas_qmatmul_exact
from band_tpu_torch.ops import quant as Q
from band_tpu_torch.ops.kernels import qmatmul as QM
from band_tpu_torch.ops.kernels.sweep_gemm import mobilenet_v2_gemms


def _k_slices(plan, K):
    """The K byte ranges of the plan's splits, as the kernel takes them."""
    step = QM.KSTEP * plan.kt_per
    return [(z * step, min(K, (z + 1) * step)) for z in range(plan.splits)]


def _check_plan(M, N, K):
    plan = QM.gemm_plan(M, N, K)
    warps, mi, _ = QM.TILES[plan.tile]
    assert (plan.bm, plan.bn) == (16 * mi * warps, QM.BN)
    assert plan.grid == (-(-M // plan.bm), -(-N // plan.bn), plan.splits)
    assert 1 <= plan.splits <= QM.MAX_SPLITS
    slices = _k_slices(plan, K)
    # whole 32-byte steps, every slice but the last full, none empty
    assert all(b - a == QM.KSTEP * plan.kt_per for a, b in slices[:-1])
    assert all(b > a for a, b in slices) or K == 0
    assert slices[0][0] == 0 and slices[-1][1] == K
    return plan


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_plan_covers_every_mobilenet_v2_gemm(batch):
    # captured from the port's program run on the CPU
    shapes = mobilenet_v2_gemms(batch)
    assert sum(shapes.values()) == 35
    for M, N, K in shapes:
        plan = _check_plan(M, N, K)
        if batch == 1 and M <= 196:
            # the late layers fill at least a quarter of the SMs
            assert plan.blocks >= 32, (M, N, K, plan)


@pytest.mark.parametrize("K", [0, 16, 24, 27, 960, 1280])
def test_plan_invariants_on_the_card_test_shapes(K):
    for M in (0, 1, 7, 49, 392, 12545):
        for N in (1, 16, 24, 33, 1000):
            _check_plan(M, N, K)


def test_tiles_match_the_kernel_source():
    src = open(os.path.join(os.path.dirname(QM.__file__), "csrc",
                            "qmatmul.cu")).read()
    cases = re.findall(
        r"case (\d+): e = launch_tile<(\d+), (\d+), (\d+)>", src)
    assert [int(c[0]) for c in cases] == list(range(len(QM.TILES)))
    assert [tuple(int(v) for v in c[1:]) for c in cases] == list(QM.TILES)


def _split_k_acc(a, b, bias, w_zp, plan):
    """The kernel's reduction: int32 partials of each K slice (products
    and row sums), added with bias in uint32 (modulo 2^32)."""
    total = np.zeros((a.shape[0], b.shape[1]), np.uint32)
    rowsum = np.zeros((a.shape[0], 1), np.uint32)
    for lo, hi in _k_slices(plan, a.shape[1]):
        part = a[:, lo:hi].astype(np.int64) @ b[lo:hi].astype(np.int64)
        assert np.abs(part).max() < 2 ** 31  # the MMA's int32 sum is exact
        total += part.astype(np.int32).view(np.uint32)
        rowsum += a[:, lo:hi].sum(axis=1, keepdims=True,
                                  dtype=np.int32).view(np.uint32)
    total -= np.uint32(w_zp % 2 ** 32) * rowsum
    total += bias.view(np.uint32)
    return total.view(np.int32)


@pytest.mark.parametrize("numerics", ["exact", "fast"])
@pytest.mark.parametrize("splits", list(range(1, QM.MAX_SPLITS + 1)))
def test_split_k_sum_is_exact(splits, numerics):
    rng = np.random.default_rng(30 + splits)
    # M x N at most one Pallas tile; 3 steps per split, the last ragged
    M, N, K = 24, 40, 3 * QM.KSTEP * splits - 5
    plan = QM.gemm_plan(M, N, K)._replace(splits=splits, kt_per=3)
    assert len(_k_slices(plan, K)) == splits
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    # a bias near +-2^31: the sum wraps in about half the outputs
    big = rng.integers(0, 5000, N)
    bias = np.where(rng.integers(0, 2, N) == 1, 2 ** 31 - 1 - big,
                    -(2 ** 31) + big).astype(np.int32)
    w_zp = 5 if numerics == "exact" else 0
    acc = _split_k_acc(a, b, bias, w_zp, plan)
    plain = QM._acc_plain(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(bias), w_zp)
    np.testing.assert_array_equal(acc, plain.numpy())
    # both sides of 2^31 occur
    exact_sum = (a.astype(np.int64) @ b.astype(np.int64) + bias
                 - w_zp * a.astype(np.int64).sum(axis=1, keepdims=True))
    assert (np.abs(exact_sum) >= 2 ** 31).any()
    assert (np.abs(exact_sum) < 2 ** 31).any()
    acc_t = torch.from_numpy(acc.astype(np.int64))
    if numerics == "exact":
        m = 2.0 ** -24 * rng.uniform(0.5, 1.5, N)
        qm, sh = JQ.quantize_multipliers(m)
        kw = dict(out_zp=128, qmin=0, qmax=255, rounding="double", w_zp=w_zp)
        want = np.asarray(pallas_qmatmul_exact(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
            jnp.asarray(qm), jnp.asarray(sh), out_dtype=np.uint8, **kw))
        got = Q.requantize_exact(acc_t, torch.from_numpy(qm).long(),
                                 torch.from_numpy(sh).long(), 128, 0, 255,
                                 torch.uint8, "double").numpy()
        plain_out = QM.qmatmul_plain(
            torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(bias),
            torch.from_numpy(qm), torch.from_numpy(sh),
            out_dtype=torch.uint8, **kw).numpy()
    else:
        mult = (2.0 ** -24 * rng.uniform(0.5, 1.5, N)).astype(np.float32)
        want = np.asarray(pallas_qmatmul(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
            jnp.asarray(mult), out_zp=-3))
        got = Q.requantize_fast(acc_t, torch.from_numpy(mult), -3, -128, 127,
                                torch.int8).numpy()
        plain_out = QM.qmatmul_fast_plain(
            torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(bias),
            torch.from_numpy(mult), out_zp=-3).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain_out, want)
    # the wrapped outputs are not all clamped to one end
    assert len(np.unique(want)) > 2
