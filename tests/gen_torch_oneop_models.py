"""One-op TFLite models built in memory, for the forms of an op that no
converter emits from a Keras model (a runtime PRELU alpha, STRIDED_SLICE's
ellipsis and new-axis masks, per-channel QUANTIZE and DEQUANTIZE, runtime
int8 FULLY_CONNECTED weights, SEGMENT_SUM with runtime ids, ...).

``one_op(op, inputs, outputs, options)`` writes a flatbuffer with TFLite's
own schema classes (tensorflow.lite.python.schema_py_generated): one
subgraph, one operator; every tensor with ``data`` is a constant, every
other input a graph input.  The tests (tests/test_torch_ops.py) write it
to a temporary file and run it through the TFLite interpreter, band_tpu
and the port.  Nothing is written under tests/data.

    spec(shape, dtype, data=None, scale=None, zero_point=None, qdim=0)
"""

import numpy as np

_TYPES = {"float32": "FLOAT32", "int8": "INT8", "uint8": "UINT8",
          "int16": "INT16", "int32": "INT32", "int64": "INT64",
          "bool": "BOOL"}


def spec(shape, dtype, data=None, scale=None, zero_point=None, qdim=0):
    """A tensor of the model: its shape and dtype, its constant data (None
    for a graph input), its quantization (per-tensor with one scale,
    per-channel along ``qdim`` with several)."""
    return dict(shape=list(shape), dtype=np.dtype(dtype), data=data,
                scale=scale, zero_point=zero_point, qdim=qdim)


def one_op(op, inputs, outputs, options=None, options_type=None):
    """The flatbuffer (bytes) of a model with one ``op`` (a BuiltinOperator
    name) from ``inputs`` to ``outputs`` (specs; None for an absent
    optional input), with builtin options ``options`` (a schema ...OptionsT
    object) of ``options_type`` (a BuiltinOptions name)."""
    import flatbuffers
    from tensorflow.lite.python import schema_py_generated as S

    code = getattr(S.BuiltinOperator, op)
    oc = S.OperatorCodeT()
    oc.builtinCode = code
    oc.deprecatedBuiltinCode = min(code, 127)
    oc.version = 1
    buffers = [S.BufferT()]
    tensors = []

    def add(t, i):
        tt = S.TensorT()
        tt.shape = t["shape"]
        tt.type = getattr(S.TensorType, _TYPES[t["dtype"].name])
        tt.name = f"t{i}".encode()
        tt.buffer = 0
        if t["data"] is not None:
            b = S.BufferT()
            b.data = np.frombuffer(np.ascontiguousarray(
                np.asarray(t["data"], t["dtype"])).tobytes(), np.uint8)
            buffers.append(b)
            tt.buffer = len(buffers) - 1
        if t["scale"] is not None:
            q = S.QuantizationParametersT()
            q.scale = list(np.atleast_1d(np.asarray(t["scale"], np.float32)))
            zp = t["zero_point"] if t["zero_point"] is not None else 0
            q.zeroPoint = list(np.broadcast_to(
                np.atleast_1d(np.asarray(zp, np.int64)), (len(q.scale),)))
            q.quantizedDimension = t["qdim"]
            tt.quantization = q
        tensors.append(tt)
        return len(tensors) - 1

    in_ids = [-1 if t is None else add(t, i) for i, t in enumerate(inputs)]
    out_ids = [add(t, len(inputs) + i) for i, t in enumerate(outputs)]
    sg = S.SubGraphT()
    sg.tensors = tensors
    sg.inputs = [i for i, t in zip(in_ids, inputs)
                 if t is not None and t["data"] is None]
    sg.outputs = out_ids
    o = S.OperatorT()
    o.opcodeIndex = 0
    o.inputs = in_ids
    o.outputs = out_ids
    if options is not None:
        o.builtinOptionsType = getattr(S.BuiltinOptions, options_type)
        o.builtinOptions = options
    sg.operators = [o]
    m = S.ModelT()
    m.version = 3
    m.operatorCodes = [oc]
    m.subgraphs = [sg]
    m.buffers = buffers
    m.description = b"one op"
    b = flatbuffers.Builder(1024)
    b.Finish(m.Pack(b), file_identifier=b"TFL3")
    return bytes(b.Output())


def options(name, **fields):
    """A schema ``<name>OptionsT`` with ``fields`` set (schema names)."""
    from tensorflow.lite.python import schema_py_generated as S

    o = getattr(S, f"{name}OptionsT")()
    for k, v in fields.items():
        setattr(o, k, v)
    return o
