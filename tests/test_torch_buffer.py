"""The port's data plane (band_tpu_torch/buffer) against band_tpu's on
seeded numpy inputs: crop, rotate, flip, orientation, colour conversions,
data-type convert and AutoConvert byte-equal; resize and normalize within
1 code (float32 normalize within band_tpu's own tolerance); the port's
native kernels against its numpy paths the same way; the native library
builds into band_tpu_torch/_build/; camera frames regenerate
bit-for-bit."""

import os

import numpy as np
import pytest

from band_tpu.buffer import buffer as jbuffer
from band_tpu.buffer import image_ops as jops
from band_tpu.buffer import processor as jproc
from band_tpu_torch.buffer import buffer as tbuffer
from band_tpu_torch.buffer import image_ops as tops
from band_tpu_torch.buffer import native as tnative
from band_tpu_torch.buffer import processor as tproc
from band_tpu_torch.buffer import synthetic

FORMATS = ("GRAY", "RGB", "RGBA")
YUV = ("NV12", "NV21", "YV21", "YV12")


def _img(seed, h, w, c):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c == 1 else (h, w, c)
    return rng.integers(0, 256, shape).astype(np.uint8)


def _pair(arr, fmt, orientation=1):
    """The same array as a band_tpu Buffer and a port Buffer."""
    j = jbuffer.Buffer.from_numpy(
        arr, jbuffer.BufferFormat[fmt], jbuffer.BufferOrientation(orientation))
    t = tbuffer.Buffer.from_numpy(
        arr, tbuffer.BufferFormat[fmt], tbuffer.BufferOrientation(orientation))
    return j, t


def _yuv_pair(seed, fmt, h=18, w=26):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    if fmt in ("NV12", "NV21"):
        p1, p2 = rng.integers(0, 256, (h // 2, w)).astype(np.uint8), None
    else:
        p1 = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
        p2 = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    j = jbuffer.Buffer.from_yuv(y, p1, p2, jbuffer.BufferFormat[fmt])
    t = tbuffer.Buffer.from_yuv(y, p1, p2, tbuffer.BufferFormat[fmt])
    return j, t


def _bytes_within_one(a, b):
    """Largest distance between two uint8/int8 arrays' bytes, mod 256:
    the int8 cast wraps, so codes 127 and 128 of a resize land at 127
    and -128 and are still one code apart."""
    d = (a.view(np.uint8).astype(np.int16) - b.view(np.uint8)) % 256
    return int(np.minimum(d, 256 - d).max())


def _same(j, t):
    assert t.format.value == j.format.value
    assert t.orientation.value == j.orientation.value
    assert (t.width, t.height) == (j.width, j.height)
    ja, ta = j.array(), t.array()
    assert ta.dtype == ja.dtype and ta.shape == ja.shape
    np.testing.assert_array_equal(ta, ja)


def test_native_library_builds_into_build_dir():
    lib = tnative.load()
    path = tnative.lib_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(path) == os.path.join(root, "band_tpu_torch",
                                                 "_build")
    assert os.path.exists(path)
    # never beside the source
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(os.path.abspath(tnative.__file__))))
    assert "-ffp-contract=off" in tnative.FLAGS
    assert lib.resize_bilinear_u8 is not None


@pytest.mark.parametrize("c", [1, 3, 4])
def test_crop_flip_rotate_byte_equal(c):
    fmt = FORMATS[(1, 3, 4).index(c)]
    img = _img(c, 37, 53, c)
    j, t = _pair(img, fmt)
    _same(jops.Crop(3, 5, 40, 30).process(j), tops.Crop(3, 5, 40, 30).process(t))
    for horizontal in (True, False):
        for native in (True, False):
            _same(jops.Flip(horizontal).process(j),
                  tops.Flip(horizontal).process(t, native))
    for deg in (0, 90, 180, 270, -90):
        for native in (True, False):
            _same(jops.Rotate(deg).process(j), tops.Rotate(deg).process(t, native))
    with pytest.raises(tops.BandError):
        tops.Crop(0, 0, 53, 10).process(t)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_correct_byte_equal(orientation):
    j, t = _pair(_img(orientation, 9, 14, 3), "RGB", orientation)
    _same(jops.OrientationCorrect().process(j),
          tops.OrientationCorrect().process(t))


@pytest.mark.parametrize("src,dst", [("RGB", "GRAY"), ("RGBA", "RGB"),
                                     ("GRAY", "RGB"), ("RGB", "RGB")])
def test_color_convert_byte_equal(src, dst):
    c = {"GRAY": 1, "RGB": 3, "RGBA": 4}[src]
    j, t = _pair(_img(7, 21, 30, c), src)
    want = jops.ColorSpaceConvert(jbuffer.BufferFormat[dst]).process(j)
    for native in (True, False):
        _same(want, tops.ColorSpaceConvert(
            tbuffer.BufferFormat[dst]).process(t, native))


@pytest.mark.parametrize("fmt", YUV)
def test_yuv_to_rgb_byte_equal(fmt):
    j, t = _yuv_pair(11, fmt)
    want = jops.ColorSpaceConvert(jbuffer.BufferFormat.RGB).process(j)
    for native in (True, False):
        _same(want, tops.ColorSpaceConvert(
            tbuffer.BufferFormat.RGB).process(t, native))


def test_unsupported_color_conversion_raises():
    _, t = _pair(_img(1, 4, 4, 1), "GRAY")
    with pytest.raises(tops.BandError, match="unsupported"):
        tops.ColorSpaceConvert(tbuffer.BufferFormat.RGBA).process(t)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int32, np.float32])
def test_data_type_convert_byte_equal(dtype):
    """uint8 -> int8 wraps codes above 127 (astype), floats round and
    clip: band_tpu's semantics byte for byte."""
    img = _img(3, 8, 9, 3)
    j, t = _pair(img, "RGB")
    _same(jops.DataTypeConvert(dtype).process(j),
          tops.DataTypeConvert(dtype).process(t))
    f = (img.astype(np.float32) - 100.0) * 1.7
    jf, tf = _pair(f, "RGB")
    _same(jops.DataTypeConvert(dtype).process(jf),
          tops.DataTypeConvert(dtype).process(tf))
    if dtype == np.int8:
        wrapped = tops.DataTypeConvert(np.int8).process(t).array()
        np.testing.assert_array_equal(wrapped.view(np.uint8), img)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("shape,size", [((37, 53, 3), (24, 16)),
                                        ((16, 16, 1), (40, 33)),
                                        ((120, 90, 4), (224, 224))])
def test_resize_within_one_code(method, shape, size):
    img = _img(5, shape[0], shape[1], shape[2])
    fmt = FORMATS[(1, 3, 4).index(shape[2])]
    j, t = _pair(img, fmt)
    want = jops.Resize(*size, method).process(j).array()
    native = tops.Resize(*size, method).process(t).array()
    numpy_path = tops.Resize(*size, method).process(t, native=False).array()
    # the numpy path is band_tpu's, byte for byte
    np.testing.assert_array_equal(
        numpy_path, jops.Resize(*size, method)._numpy_resize(
            img.reshape(shape[0], shape[1], -1)).reshape(numpy_path.shape))
    assert native.shape == want.shape
    assert _bytes_within_one(native, want) <= 1
    assert _bytes_within_one(native, numpy_path) <= 1
    if method == "nearest":
        np.testing.assert_array_equal(native, want)


@pytest.mark.parametrize("per_channel", [False, True])
def test_normalize_within_band_tpu_tolerance(per_channel):
    img = _img(9, 33, 47, 3)
    j, t = _pair(img, "RGB")
    mean, std = ((123.675, 116.28, 103.53), (58.395, 57.12, 57.375)) \
        if per_channel else (127.5, 127.5)
    want = jops.Normalize(mean, std).process(j).array()
    for native in (True, False):
        got = tops.Normalize(mean, std).process(t, native).array()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fmt,orientation", [("RGB", 1), ("RGBA", 6),
                                             ("GRAY", 3), ("NV12", 1),
                                             ("YV21", 1)])
def test_auto_convert_same_size_byte_equal(fmt, orientation):
    """Orientation, colour and type conversion without a resize."""
    if fmt in YUV:
        j, t = _yuv_pair(4, fmt, 16, 16)
    else:
        c = {"GRAY": 1, "RGB": 3, "RGBA": 4}[fmt]
        j, t = _pair(_img(4, 16, 16, c), fmt, orientation)
    shape = (1, 16, 16, 3)
    want = jproc.ImageProcessorBuilder().add_auto_convert(
        shape, np.int8).build().to_tensor(j)
    for native in (True, False):
        got = tproc.ImageProcessorBuilder().add_auto_convert(
            shape, np.int8).build().to_tensor(t, native)
        assert got.shape == want.shape == shape and got.dtype == np.int8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["RGB", "NV12"])
def test_auto_convert_camera_frame_within_one_code(fmt):
    """A camera frame (small) through AutoConvert to an int8 224x224
    input: the port's native and numpy paths within 1 code of
    band_tpu's."""
    buf = synthetic.camera_frame(21, 320, 240, tbuffer.BufferFormat[fmt])
    planes = [p.data for p in buf.planes]
    if fmt == "RGB":
        j = jbuffer.Buffer.from_numpy(planes[0])
    else:
        j = jbuffer.Buffer.from_yuv(planes[0], planes[1], None,
                                    jbuffer.BufferFormat.NV12)
    shape = (1, 224, 224, 3)
    want = jproc.ImageProcessorBuilder().add_auto_convert(
        shape, np.int8).build().to_tensor(j)
    proc = tproc.ImageProcessorBuilder().add_auto_convert(
        shape, np.int8).build()
    for native in (True, False):
        got = proc.to_tensor(buf, native)
        assert got.shape == shape and got.dtype == np.int8
        assert _bytes_within_one(got, want) <= 1


def test_processor_pipeline_matches_band_tpu():
    img = _img(13, 60, 80, 3)
    j, t = _pair(img, "RGB")

    def build(mod):
        return (mod.ImageProcessorBuilder().add_crop(4, 2, 63, 49)
                .add_flip(True).add_rotate(90).add_resize(20, 30, "nearest")
                .add_color_space_convert(type(j.format)["GRAY"]
                                         if mod is jproc else
                                         tbuffer.BufferFormat.GRAY)
                .add_normalize(127.5, 127.5).build())

    want = build(jproc).to_tensor(j)
    got = build(tproc).to_tensor(t)
    assert got.shape == want.shape == (1, 30, 20, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_camera_frames_regenerate():
    """Same seed, same bytes; another seed, other bytes; NV12 planes have
    the camera layout."""
    a = synthetic.camera_frame(5, 64, 48)
    b = synthetic.camera_frame(5, 64, 48)
    assert synthetic.frame_digest(a) == synthetic.frame_digest(b)
    assert synthetic.frame_digest(a) != synthetic.frame_digest(
        synthetic.camera_frame(6, 64, 48))
    nv = synthetic.camera_frame(5, 64, 48, tbuffer.BufferFormat.NV12)
    assert [p.data.shape for p in nv.planes] == [(48, 64), (24, 64)]
    assert len(synthetic.frame_bytes(nv)) == 64 * 48 * 3 // 2
    with pytest.raises(ValueError):
        synthetic.camera_frame(5, 63, 48, tbuffer.BufferFormat.NV12)


def test_frontend_goldens_match_the_frames():
    """tests/data/torch_frontend_goldens.npz: each frame regenerates to
    its stored digest, and the port's AutoConvert of it is within 1 code
    of band_tpu's stored tensor."""
    from tests import gen_torch_frontend_goldens as gen

    z = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "torch_frontend_goldens.npz"))
    assert tuple(z["seeds"]) == gen.SEEDS
    proc = tproc.ImageProcessorBuilder().add_auto_convert(
        (1, 224, 224, 3), np.int8).build()
    for seed, fmt, buf in gen.frames()[::3]:
        k = gen.SEEDS.index(seed)
        assert synthetic.frame_digest(buf) == str(z["frame_sha"][k])
        assert _bytes_within_one(proc.to_tensor(buf), z["tensors"][k]) <= 1


def test_preprocess_bench_runs_every_operator():
    from band_tpu_torch.tools import preprocess_bench

    results = preprocess_bench.run_all(budget_s=0.01)
    assert [r["op"] for r in results][-1] == "auto_convert_1080p->224_uint8"
    assert len(results) == 10
    assert all(r["mb_s"] > 0 and r["ms_per_call"] > 0 for r in results)
    assert results[-1]["fps_per_core"] > 0
