"""The quantized softmax kernel's plan (``softmax_plan``: a block per row
for long rows, a thread per row for short ones) and the row kernel's
arithmetic, on the CPU.

The CUDA kernel (csrc/lut_softmax.cu) runs only on the card, where
tests/test_torch_cuda.py and chip_smoke.py hold it byte-equal to the
plain version.  Here numpy replays the row kernel block by block: the
row staged by aligned 16-byte chunks (bytes at the ragged ends), the
integer max per thread, per warp and across warps, the e values written
in parallel, ONE thread's float32 row sum taken left to right in steps
of 16, and the output pass by aligned 4-byte words.  The replay is held
byte-equal (tolerance 0) to band_tpu's ``lut_softmax`` and its row sums
bit-equal to band_tpu's left-to-right ``lax.scan``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from band_tpu.ops import quant as JQ
from band_tpu_torch.ops.kernels import softmax as SM
from band_tpu_torch.ops.kernels.sweep_gemm import capture_calls

SRC = os.path.join(os.path.dirname(SM.__file__), "csrc", "lut_softmax.cu")


@pytest.fixture
def one_thread():
    """The capture runs a whole model in plain PyTorch: on one thread it
    takes seconds, where test workers that share the cores would each
    start a thread per core and slow one another down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("model,batch,depth", [
    (m, b, d) for m, d in (("mobilenet_v2_int8", 1000), ("effnetlite_int8", 10),
                           ("resnetish_int8", 10), ("fc_int8", 10),
                           ("quant_act_int8", 8))
    for b in (1, 8)])
def test_plan_for_every_softmax_call(model, batch, depth, one_thread):
    """Captured from the port's program run on the CPU: MobileNetV2's
    1000 classes take the row kernel, the 10-class heads and
    quant_act_int8's rows of 8 the thread kernel."""
    calls = capture_calls(model, batch, "lut_softmax",
                          lambda x, *a, **kw: tuple(x.shape))
    assert sum(calls.values()) == 1
    (shape,) = calls
    assert shape[-1] == depth and np.prod(shape) // depth in (batch,
                                                               64 * batch)
    plan = SM.softmax_plan(int(np.prod(shape)) // depth, depth)
    assert plan.branch == (SM.ROW if depth >= SM.ROW_MIN_DEPTH else SM.THREAD)
    assert plan.branch == (SM.ROW if model == "mobilenet_v2_int8"
                           else SM.THREAD)


@pytest.mark.parametrize("rows,depth", [(1, 1), (1, 31), (8, 32), (64, 511),
                                        (1, 512), (3, 4000), (2, 9000),
                                        (1, 9500), (5, 100000)])
def test_plan_branches(rows, depth):
    """The row kernel from ROW_MIN_DEPTH while its shared memory fits
    (48 KB: depth up to ~9,500), the thread kernel otherwise."""
    plan = SM.softmax_plan(rows, depth)
    row = depth >= SM.ROW_MIN_DEPTH and SM.row_smem(depth) <= SM.MAX_SMEM
    assert plan.branch == (SM.ROW if row else SM.THREAD)
    if row:
        assert plan.blocks == rows and plan.threads % 32 == 0
        assert plan.threads <= SM.ROW_MAX_THREADS
        # the buffer holds the table, the e values and the staged chunks
        assert plan.smem >= 4 * (256 + depth) + 16 * ((15 + depth + 15) // 16)
    else:
        assert plan.blocks * plan.threads >= rows


# lines of csrc/lut_softmax.cu that the replay below follows
KERNEL_SOURCE = [
    "const int x_off = static_cast<int>(reinterpret_cast<uintptr_t>(xr) & 15);",
    "const int chunks = (x_off + depth + 15) / 16;",
    "for (int j = tid; j < chunks; j += nt) {",
    "const int lo = 16 * j - x_off;",
    "if (lo >= 0 && lo + 16 <= depth) {",
    "for (int d = 16; d > 0; d /= 2) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));",
    "if (tid % 32 == 0) s_max[tid / 32] = mx;",
    "for (int k = 1; k < nt / 32; ++k) mx = max(mx, s_max[k]);",
    "for (int i = 4 * tid; i < row_e_floats(depth); i += 4 * nt) {",
    "return (depth + 15) / 16 * 16;",
    "? s_table[255 - mx + value_of(s_x[x_off + i + b], in_uint8)]",
    "if (tid == 0) {",
    "const int blocks = row_e_floats(depth) / 16;",
    "s = __fadd_rn(s, a.x); s = __fadd_rn(s, a.y);",
    "s = __fadd_rn(s, a.z); s = __fadd_rn(s, a.w);",
    "s = __fadd_rn(s, b.x); s = __fadd_rn(s, b.y);",
    "s = __fadd_rn(s, d.z); s = __fadd_rn(s, d.w);",
    "a = na; b = nb; c = nc; d = nd;",
    "s_inv = __fdiv_rn(1.0f, __fmul_rn(s, out_scale));",
    "int q = static_cast<int>(__fadd_rn(__fmul_rn(e, inv), 0.5f)) + out_zp;",
    "const int o_off = static_cast<int>(reinterpret_cast<uintptr_t>(orow) & 3);",
    "const int owords = (o_off + depth + 3) / 4;",
    "const int lo = 4 * j - o_off;",
    "w |= static_cast<uint32_t>(quantize(e[b], inv, out_zp, qmin, qmax))",
    "orow[i] = quantize(s_e[i], inv, out_zp, qmin, qmax);",
]


def test_knockout_copies_remove_one_phase_each():
    """knockout.py's copies of csrc/lut_softmax.cu (the serial sum, the
    e values, the output pass removed) find their markers and differ."""
    from band_tpu_torch.ops.kernels import knockout

    variants = knockout._variants("lut_softmax")
    assert set(variants) == {"whole", "no_sum", "no_epass", "no_out"}
    assert variants["whole"] == open(SRC).read()
    assert len({v for v in variants.values()}) == 4


def test_replay_follows_the_kernel_source():
    src = " ".join(open(SRC).read().split())
    for line in KERNEL_SOURCE:
        assert " ".join(line.split()) in src, line
    # the one serial sum: four float4 of e per step, in order
    step = src[src.index("for (int k = 0; k < blocks; ++k) {"):
               src.index("a = na; b = nb;")]
    adds = [f"s = __fadd_rn(s, {v}.{c});" for v in "abcd" for c in "xyzw"]
    pos = [step.index(a) for a in adds]
    assert pos == sorted(pos)
    assert "na = e4[4 * k + 4]; nb = e4[4 * k + 5];" in step
    assert "nc = e4[4 * k + 6]; nd = e4[4 * k + 7];" in step


def _values(b, in_uint8):
    return b.astype(np.int64) if in_uint8 else b.view(np.int8).astype(np.int64)


def _replay_rows(x, table, out_scale, out_zp, qmin, qmax, threads, x_base,
                 o_base):
    """The row kernel, one block per row of ``threads`` threads, with x and
    out at byte offsets x_base and o_base from 16-byte alignment (out
    in 4-byte words).
    Returns (output bytes, row sums)."""
    rows, depth = x.shape
    in_uint8 = x.dtype == np.uint8
    xb = x.view(np.uint8)
    e = np.zeros((rows, depth), np.float32)
    for r in range(rows):
        xr = xb[r]
        x_off = (x_base + r * depth) % 16
        chunks = (x_off + depth + 15) // 16
        s_x = np.zeros(16 * chunks, np.uint8)
        mx = np.full(threads, -256, np.int64)
        for j in range(chunks):
            tid = j % threads                    # j = tid, tid + nt, ...
            lo = 16 * j - x_off
            idx = lo + np.arange(16)
            ok = (idx >= 0) & (idx < depth)
            s_x[16 * j + np.flatnonzero(ok)] = xr[idx[ok]]
            mx[tid] = max(mx[tid], _values(xr[idx[ok]], in_uint8).max())
        per_warp = mx.reshape(threads // 32, 32).max(axis=1)
        row_max = per_warp[0]
        for k in range(1, threads // 32):
            row_max = max(row_max, per_warp[k])
        e[r] = table[255 - row_max + _values(s_x[x_off:x_off + depth],
                                             in_uint8)]
    # thread 0's left-to-right sum, 16 values a step, e padded with zeros
    # to a multiple of 16 (every row at once: each row's order is its own)
    blocks = -(-depth // 16)
    ep = np.zeros((rows, 16 * blocks), np.float32)
    ep[:, :depth] = e
    s = np.zeros(rows, np.float32)
    for k in range(blocks):
        for i in range(16 * k, 16 * k + 16):
            s = (s + ep[:, i]).astype(np.float32)
    inv = (np.float32(1.0) / (s * np.float32(out_scale))).astype(np.float32)
    out = np.zeros((rows, depth), np.uint8)
    for r in range(rows):
        o_off = (o_base + r * depth) % 4
        for j in range((o_off + depth + 3) // 4):
            lo = 4 * j - o_off
            idx = lo + np.arange(4)
            idx = idx[(idx >= 0) & (idx < depth)]
            prob = (e[r, idx] * inv[r]).astype(np.float32)
            q = (prob + np.float32(0.5)).astype(np.int32) + out_zp
            out[r, idx] = np.clip(q, qmin, qmax).astype(np.uint8)
    return out, s


def _band_tpu(x, table, out_scale, out_zp, out_dtype):
    """band_tpu's lut_softmax, and the row sums its lax.scan takes."""
    want = np.asarray(JQ.lut_softmax(jnp.asarray(x), jnp.asarray(table),
                                     out_scale, out_zp, out_dtype))
    xi = jnp.asarray(x).astype(jnp.int32)
    mx = jnp.max(xi, axis=-1, keepdims=True)
    e = jnp.asarray(table)[255 - mx + xi]
    sums, _ = lax.scan(lambda c, v: (c + v, None),
                       jnp.zeros(e.shape[:-1], jnp.float32),
                       jnp.moveaxis(e, -1, 0))
    return want, np.asarray(sums)


@pytest.mark.parametrize("depth", [8, 10, 1000, 1001])
@pytest.mark.parametrize("rows", [1, 8, 64])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (np.int8, np.int8), (np.uint8, np.uint8), (np.int8, np.uint8),
    (np.uint8, np.int8)])
def test_row_replay_matches_band_tpu(depth, rows, in_dtype, out_dtype):
    """The row kernel replayed under its plan's block and under 32 and
    256 threads, with x and out at several offsets from 16-byte
    alignment (so rows start mid-chunk and chunks straddle rows' ends):
    outputs byte-equal to band_tpu's lut_softmax and to the plain
    version, row sums bit-equal to band_tpu's lax.scan."""
    rng = np.random.default_rng(depth * 7 + rows)
    info = np.iinfo(in_dtype)
    x = rng.integers(info.min, info.max + 1, (rows, depth)).astype(in_dtype)
    table = JQ.softmax_table(float(rng.uniform(0.02, 0.2)), 1.0)
    if out_dtype == np.int8:
        out_scale, out_zp, qmin, qmax = 1.0 / 256, -128, -128, 127
    else:
        out_scale, out_zp, qmin, qmax = 1.0 / 255, 0, 0, 255
    want, want_sums = _band_tpu(x, table, out_scale, out_zp, out_dtype)
    plain = SM.lut_softmax_plain(torch.from_numpy(x),
                                 torch.from_numpy(table), out_scale, out_zp,
                                 out_dtype).numpy()
    np.testing.assert_array_equal(plain, want)
    threads = {SM.row_plan(rows, depth).threads, 32, 256}
    for t, x_base, o_base in [(t, b, (3 * b) % 16) for t in sorted(threads)
                              for b in (0, 1, 8)]:
        got, sums = _replay_rows(x, table, out_scale, out_zp, qmin, qmax, t,
                                 x_base, o_base)
        np.testing.assert_array_equal(sums.view(np.uint32),
                                      want_sums.view(np.uint32))
        np.testing.assert_array_equal(got.view(out_dtype), want,
                                      err_msg=f"threads {t} x+{x_base}")
