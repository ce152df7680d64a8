"""Python glue for the C ABI (band_c.cc).

A port of band_tpu/c/_embed.py over the port's engine and data plane;
it imports torch, never jax.  The C layer keeps data as (bytes, dtype-string, dims) triples and opaque
PyObject handles; everything engine-shaped happens here so the C++ side
never touches numpy/engine internals.  Mirrors the reference's
c_api_internal wrappers (band/c/c_api_internal.h:32-76) in role.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..common import DeviceFlag, JobStatus, RequestOption
from ..config import config_from_dict
from ..errors import DeadlineExceeded
from ..ir.model import Model
from ..runtime.engine import Engine

RawTensor = Tuple[bytes, str, List[int]]

# C-side BandStatus values
_OK, _ERROR, _DEADLINE = 0, 1, 2

_STATUS_TO_C = {
    JobStatus.SUCCESS: _OK,
    JobStatus.SLO_VIOLATION: _DEADLINE,
}


def merge_json(d: Dict, text: str) -> None:
    obj = json.loads(text)
    if not isinstance(obj, dict):
        raise ValueError("config JSON fragment must be an object")
    d.update(obj)


def set_key(d: Dict, key: str, value: str) -> None:
    parts = key.split(".")
    cur = d
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    try:
        v = json.loads(value)
    except (json.JSONDecodeError, ValueError):
        v = value
    cur[parts[-1]] = v


def build_config(d: Dict):
    return config_from_dict(dict(d))


def build_config_from_file(path: str):
    with open(path) as f:
        return config_from_dict(json.load(f))


def model_from_path(path: str) -> Model:
    return Model.from_path(path)


def model_from_buffer(data: bytes) -> Model:
    return Model.from_buffer(bytes(data))


def engine_create(cfg) -> Engine:
    return Engine.create(cfg)


def engine_create_default() -> Engine:
    """Default config (reference: BandEngineCreateWithDefaultConfig):
    one GPU worker per visible CUDA card, at least one, plus a host
    worker, fixed-worker scheduling.  Without a card the engine refuses
    to start (ConfigError): the default never serves on the host alone."""
    import torch

    workers = [
        {"device": "gpu", "device_ids": [i]}
        for i in range(max(torch.cuda.device_count(), 1))
    ]
    workers.append({"device": "cpu", "device_ids": [0]})
    return Engine.create(config_from_dict(
        {"schedulers": ["fixed_worker"], "workers": workers}
    ))


def engine_shutdown(engine: Engine) -> None:
    engine.shutdown()


def register_model(engine: Engine, model: Model) -> int:
    return engine.register_model(model)


def unregister_model(engine: Engine, model_id: int) -> None:
    engine.unregister_model(model_id)


def num_workers(engine: Engine) -> int:
    return engine.num_workers()


def worker_device(engine: Engine, worker_id: int) -> int:
    """band_c.h BandDeviceFlag: kBandCpu (0) for a host worker,
    kBandGpu (= kBandTpu, 1: the accelerator) for a card's."""
    spec = engine.config.worker.workers[worker_id]
    return 0 if spec.device == DeviceFlag.CPU else 1


def tensor_specs(engine: Engine, model_id: int, which: str):
    """[(dims, dtype_str, name, nbytes, quant)] for a model's
    inputs/outputs; quant is None or (scales, zero_points, dim)."""
    g = engine.model_record(model_id).model.graph
    ids = g.inputs if which == "in" else g.outputs
    out = []
    for t in ids:
        td = g.tensor(t)
        dt = np.dtype(td.dtype)
        dims = [int(s) for s in td.shape]
        quant = None
        if td.quant is not None:
            quant = (
                [float(s) for s in np.ravel(td.quant.scale)],
                [int(z) for z in np.ravel(td.quant.zero_point)],
                int(td.quant.quantized_dimension),
            )
        out.append((dims, dt.str if dt.kind == "V" else dt.name,
                    td.name or "", int(np.prod(dims or [1])) * dt.itemsize,
                    quant))
    return out


def _to_arrays(raw_inputs: Sequence[RawTensor]) -> List[np.ndarray]:
    return [
        np.frombuffer(b, dtype=np.dtype(dt)).reshape(dims)
        for b, dt, dims in raw_inputs
    ]


def _from_arrays(outs: Sequence[np.ndarray]) -> List[RawTensor]:
    return [
        (np.ascontiguousarray(o).tobytes(), np.dtype(o.dtype).name,
         [int(s) for s in o.shape])
        for o in outs
    ]


def make_option(target_worker: int, require_callback: int, slo_us: int,
                slo_scale: float) -> RequestOption:
    return RequestOption(
        target_worker=target_worker,
        require_callback=bool(require_callback),
        slo_us=slo_us,
        slo_scale=slo_scale,
    )


def request_sync(engine: Engine, model_id: int,
                 raw_inputs: Sequence[RawTensor], option: RequestOption,
                 timeout: float = 120.0):
    """Returns (status:int, outputs:[RawTensor])."""
    try:
        outs = engine.request_sync(model_id, _to_arrays(raw_inputs), option,
                                   timeout=timeout)
    except DeadlineExceeded:
        return _DEADLINE, []
    return _OK, _from_arrays(outs)


def request_async(engine: Engine, model_id: int,
                  raw_inputs: Sequence[RawTensor],
                  option: RequestOption) -> int:
    return engine.request_async(model_id, _to_arrays(raw_inputs), option)


def wait(engine: Engine, job_id: int, timeout: float = 120.0):
    """Returns (status:int, outputs:[RawTensor])."""
    try:
        outs = engine.wait(job_id, timeout=timeout)
    except DeadlineExceeded:
        return _DEADLINE, []
    return _OK, _from_arrays(outs)


def set_on_end_request(engine: Engine, c_callable) -> int:
    """Register a C trampoline; it receives (job_id, c_status).
    Returns the callback handle for unset_on_end_request."""

    def cb(job_id: int, status: JobStatus) -> None:
        c_callable(int(job_id), _STATUS_TO_C.get(status, _ERROR))

    return engine.register_callback(cb)


def unset_on_end_request(engine: Engine, handle: int) -> bool:
    return engine.unregister_callback(handle)


def set_log_severity(level: int) -> None:
    from ..tracing.logger import Logger, LogSeverity

    Logger.get().set_verbosity(LogSeverity(level))


def set_log_reporter(c_callable) -> int:
    from ..tracing.logger import Logger

    return Logger.get().add_reporter(
        lambda sev, msg: c_callable(int(sev), str(msg))
    )


def unset_log_reporter(handle: int) -> None:
    from ..tracing.logger import Logger

    Logger.get().remove_reporter(handle)


# C-enum mapping for numpy dtype names (band_c.h BandDataType)
_DTYPE_TO_C = {
    "float32": 1, "int32": 2, "uint8": 3, "int64": 4, "bool": 6,
    "int16": 7, "complex64": 8, "int8": 9, "float16": 10, "float64": 11,
}


def dtype_to_c(name: str) -> int:
    return _DTYPE_TO_C.get(name, 0)


# -- buffer + image processor (band_c.h BandBuffer/BandImageProcessor) --


def _c_buffer_format(fmt: int):
    from ..buffer.buffer import BufferFormat

    # band_c.h BandBufferFormat values (= reference c_api_type.h:104-117)
    table = {
        0: BufferFormat.GRAY, 1: BufferFormat.RGB, 2: BufferFormat.RGBA,
        3: BufferFormat.YV12, 4: BufferFormat.YV21, 5: BufferFormat.NV21,
        6: BufferFormat.NV12, 7: BufferFormat.RAW,
    }
    if fmt not in table:
        raise ValueError(f"unknown buffer format enum {fmt}")
    return table[fmt]


def buffer_from_raw(data: bytes, width: int, height: int, fmt: int):
    """Single-blob image → Buffer (band_c.h BandBufferSetFromRawData)."""
    from ..buffer.buffer import Buffer, BufferFormat

    f = _c_buffer_format(fmt)
    w, h = int(width), int(height)
    a = np.frombuffer(data, np.uint8)
    if f == BufferFormat.GRAY:
        return Buffer.from_numpy(a[: w * h].reshape(h, w).copy(), f)
    if f == BufferFormat.RGB:
        return Buffer.from_numpy(a[: w * h * 3].reshape(h, w, 3).copy(), f)
    if f == BufferFormat.RGBA:
        return Buffer.from_numpy(a[: w * h * 4].reshape(h, w, 4).copy(), f)
    if w % 2 or h % 2:
        raise ValueError(
            "YUV buffers require even width/height (4:2:0 subsampling)"
        )
    ch, cw = h // 2, w // 2
    y = a[: w * h].reshape(h, w).copy()
    rest = a[w * h:]
    if f in (BufferFormat.NV12, BufferFormat.NV21):
        uv = rest[: w * ch].reshape(ch, w).copy()
        return Buffer.from_yuv(y, uv, None, f)
    # Planar: planes follow in the format's memory order; from_yuv stores
    # them in order and the color converter swaps per format.
    q = cw * ch
    p1 = rest[:q].reshape(ch, cw).copy()
    p2 = rest[q: 2 * q].reshape(ch, cw).copy()
    return Buffer.from_yuv(y, p1, p2, f)


def buffer_from_yuv(y: bytes, u: bytes, v: bytes, width: int, height: int,
                    row_stride_y: int, row_stride_uv: int,
                    pixel_stride_uv: int, fmt: int):
    """Stride-aware YUV planes → Buffer (BandBufferSetFromYUVData)."""
    from ..buffer.buffer import Buffer, BufferFormat

    f = _c_buffer_format(fmt)
    w, h = int(width), int(height)
    if w % 2 or h % 2:
        raise ValueError(
            "YUV buffers require even width/height (4:2:0 subsampling)"
        )
    ch, cw = h // 2, w // 2

    def rows(raw: bytes, n_rows: int, stride: int, row_width: int):
        # tolerate an unpadded final row (stride*(n-1)+row_width bytes)
        a = np.frombuffer(raw, np.uint8)
        out = np.empty((n_rows, row_width), np.uint8)
        for r in range(n_rows):
            out[r] = a[r * stride: r * stride + row_width]
        return out

    y_arr = rows(y, h, int(row_stride_y), w)
    if f in (BufferFormat.NV12, BufferFormat.NV21):
        uv = rows(u, ch, int(row_stride_uv), w)
        return Buffer.from_yuv(y_arr, uv, None, f)

    def plane(raw: bytes) -> np.ndarray:
        ps = int(pixel_stride_uv)
        p = rows(raw, ch, int(row_stride_uv), (cw - 1) * ps + 1)
        return np.ascontiguousarray(p[:, ::ps][:, :cw])

    u_arr, v_arr = plane(u), plane(v)
    # from_yuv stores planes in memory order: YV21/I420 is U-then-V,
    # YV12 is V-then-U (see image_ops._yuv_to_rgb).
    p1, p2 = (u_arr, v_arr) if f == BufferFormat.YV21 else (v_arr, u_arr)
    return Buffer.from_yuv(y_arr, p1, p2, f)


def image_process(ops, buf, dims, dtype: str) -> bytes:
    """Run an op list (or the auto pipeline when empty) and return the
    raw output bytes for a target tensor of the given dims/dtype."""
    from ..buffer.processor import ImageProcessorBuilder

    b = ImageProcessorBuilder()
    if not ops:
        b.add_auto_convert(list(dims), np.dtype(dtype))
    for field, args in ops:
        if field == 0:  # BAND_CROP
            b.add_crop(*(int(a) for a in args))
        elif field == 1:  # BAND_RESIZE
            b.add_resize(int(args[0]), int(args[1]))
        elif field == 2:  # BAND_ROTATE
            b.add_rotate(int(args[0]))
        elif field == 3:  # BAND_FLIP (horizontal, vertical)
            if int(args[0]):
                b.add_flip(True)
            if int(args[1]):
                b.add_flip(False)
        elif field == 4:  # BAND_COLOR_SPACE_CONVERT
            b.add_color_space_convert(_c_buffer_format(int(args[0])))
        elif field == 5:  # BAND_NORMALIZE
            b.add_normalize(float(args[0]), float(args[1]))
        elif field == 6:  # BAND_DATA_TYPE_CONVERT → target tensor dtype
            b.add_data_type_convert(np.dtype(dtype))
        else:
            raise ValueError(f"unknown image processor field {field}")
    out = np.ascontiguousarray(b.build().process(buf).array())
    expected = int(np.prod([int(d) for d in dims] or [1]))
    expected *= np.dtype(dtype).itemsize
    if out.nbytes != expected:
        raise ValueError(
            f"image pipeline produced {out.nbytes} bytes for a "
            f"{expected}-byte target tensor {list(dims)}:{dtype}"
        )
    return out.tobytes()
