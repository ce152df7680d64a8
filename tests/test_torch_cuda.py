"""The port on the card: each CUDA kernel byte-equal to its plain
PyTorch version (tolerance 0), and a GPU worker serving the goldens.
Every test here is marked ``cuda`` and skips without CUDA (a CUDA kernel
has no CPU mode; the plain versions are held to band_tpu by the other
test_torch_* files).

This file imports neither jax nor band_tpu, so it also runs on a machine
without them; there, skip the repository's conftest (which sets up jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

import band_tpu_torch as bt
from band_tpu_torch.ops import kernels as K
from band_tpu_torch.ops import quant as Q

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ROUNDINGS = ["single", "double", "ruy"]
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _epilogue(rng, n, k, dev):
    m = 30.0 / (np.sqrt(k) * 73.0 * 73.0) * rng.uniform(0.5, 2.0, n)
    qm, sh = Q.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, n).astype(np.int32)
    return [torch.from_numpy(v).to(dev) for v in (bias, qm, sh)]


def _i8(rng, dev, *shape):
    return torch.from_numpy(
        rng.integers(-128, 128, shape).astype(np.int8)).to(dev)


def _args(out_dtype, rounding, w_zp):
    if out_dtype == torch.uint8:
        return dict(out_zp=128, qmin=0, qmax=255, rounding=rounding,
                    w_zp=w_zp, out_dtype=out_dtype)
    return dict(out_zp=-3, qmin=-128, qmax=127, rounding=rounding,
                w_zp=w_zp, out_dtype=out_dtype)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("w_zp,out_dtype", [(0, torch.int8),
                                            (5, torch.uint8)])
def test_kernels_match_plain(dev, rounding, w_zp, out_dtype):
    rng = np.random.default_rng(17)
    args = _args(out_dtype, rounding, w_zp)
    a, b = _i8(rng, dev, 70, 27), _i8(rng, dev, 27, 20)
    epi = _epilogue(rng, 20, 27, dev)
    K.reset_launches()
    got = K.qmatmul_exact(a, b, *epi, **args)
    assert K.launch_counts()["qmatmul_exact"] == 1
    assert torch.equal(got, K.qmatmul_plain(a, b, *epi, **args))
    x = _i8(rng, dev, 2, 9, 10, 4)
    wk = _i8(rng, dev, 9 * 4, 20)
    conv = dict(args, kh=3, kw=3, stride=(2, 1), dilation=(1, 2),
                padding=((1, 1), (2, 2)), x_zp=-6)
    assert torch.equal(K.qconv2d_exact(x, wk, *epi, **conv),
                       K.qconv2d_plain(x, wk, *epi, **conv))
    wd = _i8(rng, dev, 9, 8)
    epi8 = _epilogue(rng, 8, 9, dev)
    dw = dict(args, kh=3, kw=3, stride=(2, 2), padding=((0, 1), (0, 1)),
              x_zp=4, dilation=(1, 1))
    assert torch.equal(K.qdwconv2d_exact(x, wd, *epi8, **dw),
                       K.qdwconv2d_plain(x, wd, *epi8, **dw))
    assert K.launch_counts()["qconv2d_exact"] == 1
    assert K.launch_counts()["qdwconv2d_exact"] == 1


@pytest.mark.parametrize("depth,in_dtype", [(1000, torch.int8),
                                            (10, torch.uint8)])
def test_softmax_kernel_matches_plain(dev, depth, in_dtype):
    rng = np.random.default_rng(18)
    lo, hi = (-128, 128) if in_dtype == torch.int8 else (0, 256)
    x = torch.from_numpy(rng.integers(lo, hi, (5, depth))).to(in_dtype).to(
        dev)
    table = torch.from_numpy(Q.softmax_table(0.0625, 1.0)).to(dev)
    zp = -128 if in_dtype == torch.int8 else 0
    assert torch.equal(K.lut_softmax(x, table, 1.0 / 256, zp, in_dtype),
                       K.lut_softmax_plain(x, table, 1.0 / 256, zp,
                                           in_dtype))


def _golden_inputs(z, name, td):
    """tests/gen_torch_goldens.py's inputs of ``name``, regenerated from
    their seed (this file imports nothing of the tests package) and
    checked against the digest the generator stored."""
    import hashlib

    info = np.iinfo(td.dtype)
    n = len(z[f"{name}/output"])
    xs = np.random.default_rng(int(z[f"{name}/seed"])).integers(
        info.min, info.max + 1, size=(n, *td.shape), dtype=np.int64
    ).astype(td.dtype)
    assert hashlib.sha256(xs.tobytes()).hexdigest() == str(
        z[f"{name}/input_sha"])
    return xs


def test_gpu_worker_serves_the_goldens(dev):
    z = np.load(os.path.join(DATA, "torch_goldens.npz"))
    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType.FIXED_WORKER)
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0,), max_batch=4))
           .build())
    eng = bt.Engine.create(cfg)
    try:
        mid = eng.register_model(
            bt.Model.from_path(os.path.join(DATA, "fc_int8.tflite")))
        g = eng.model_record(mid).model.graph
        td = g.tensor(g.inputs[0])
        want = z["fc_int8/output"]
        xs = _golden_inputs(z, "fc_int8", td)
        K.reset_launches()
        ids = [eng.request_async(mid, [x]) for x in xs]
        for i, j in enumerate(ids):
            np.testing.assert_array_equal(eng.wait(j)[0], want[i])
        assert K.launch_counts()["qmatmul_exact"] > 0
    finally:
        eng.shutdown()
