"""``.tflite`` FlatBuffer → IR graph parser (from scratch, no TF dep).

Plays the role of the reference's model loading + introspection
(band/backend/tfl/model.cc, band/backend/tfl/model_executor.cc:48-171)
but produces an explicit backend-neutral IR consumed by the executor.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..errors import ModelError
from ..ir.graph import Graph, OpNode, QuantParams, TensorDef
from . import schema as S
from .flatbuffer import Table, file_identifier, root_table

_PADDING = {0: "SAME", 1: "VALID"}
_ACT = {0: "NONE", 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6", 4: "TANH", 5: "SIGN_BIT"}


def _conv2d_options(t: Table) -> Dict[str, Any]:
    return {
        "padding": _PADDING.get(t.i8(0), "SAME"),
        "stride_w": t.i32(1, 0) or 1,
        "stride_h": t.i32(2, 0) or 1,
        "activation": _ACT.get(t.i8(3), "NONE"),
        "dilation_w": t.i32(4, 1),
        "dilation_h": t.i32(5, 1),
    }


def _dwconv2d_options(t: Table) -> Dict[str, Any]:
    return {
        "padding": _PADDING.get(t.i8(0), "SAME"),
        "stride_w": t.i32(1, 0) or 1,
        "stride_h": t.i32(2, 0) or 1,
        "depth_multiplier": t.i32(3, 0),
        "activation": _ACT.get(t.i8(4), "NONE"),
        "dilation_w": t.i32(5, 1),
        "dilation_h": t.i32(6, 1),
    }


def _pool2d_options(t: Table) -> Dict[str, Any]:
    return {
        "padding": _PADDING.get(t.i8(0), "SAME"),
        "stride_w": t.i32(1, 0) or 1,
        "stride_h": t.i32(2, 0) or 1,
        "filter_w": t.i32(3, 0),
        "filter_h": t.i32(4, 0),
        "activation": _ACT.get(t.i8(5), "NONE"),
    }


def _fc_options(t: Table) -> Dict[str, Any]:
    return {
        "activation": _ACT.get(t.i8(0), "NONE"),
        "weights_format": t.i8(1, 0),
        "keep_num_dims": t.bool_(2),
        "asymmetric_quantize_inputs": t.bool_(3),
    }


def _softmax_options(t: Table) -> Dict[str, Any]:
    return {"beta": t.f32(0, 1.0)}


def _act_only_options(t: Table) -> Dict[str, Any]:
    return {"activation": _ACT.get(t.i8(0), "NONE")}


def _concat_options(t: Table) -> Dict[str, Any]:
    return {"axis": t.i32(0, 0), "activation": _ACT.get(t.i8(1), "NONE")}


def _reshape_options(t: Table) -> Dict[str, Any]:
    ns = t.scalar_vector(0, np.int32)
    return {"new_shape": [int(x) for x in ns]} if ns.size else {}


def _reducer_options(t: Table) -> Dict[str, Any]:
    return {"keep_dims": t.bool_(0)}


def _strided_slice_options(t: Table) -> Dict[str, Any]:
    return {
        "begin_mask": t.i32(0, 0),
        "end_mask": t.i32(1, 0),
        "ellipsis_mask": t.i32(2, 0),
        "new_axis_mask": t.i32(3, 0),
        "shrink_axis_mask": t.i32(4, 0),
    }


def _resize_bilinear_options(t: Table) -> Dict[str, Any]:
    return {"align_corners": t.bool_(2), "half_pixel_centers": t.bool_(3)}


def _resize_nn_options(t: Table) -> Dict[str, Any]:
    return {"align_corners": t.bool_(0), "half_pixel_centers": t.bool_(1)}


def _leaky_relu_options(t: Table) -> Dict[str, Any]:
    return {"alpha": t.f32(0, 0.0)}


def _transpose_conv_options(t: Table) -> Dict[str, Any]:
    return {
        "padding": _PADDING.get(t.i8(0), "SAME"),
        "stride_w": t.i32(1, 0) or 1,
        "stride_h": t.i32(2, 0) or 1,
        "activation": _ACT.get(t.i8(3), "NONE"),
    }


def _reverse_sequence_options(t: Table) -> Dict[str, Any]:
    return {"seq_dim": t.i32(0, 0), "batch_dim": t.i32(1, 0)}


def _conv3d_options(t: Table) -> Dict[str, Any]:
    return {
        "padding": _PADDING.get(t.i8(0), "SAME"),
        "stride_d": t.i32(1, 0) or 1,
        "stride_w": t.i32(2, 0) or 1,
        "stride_h": t.i32(3, 0) or 1,
        "activation": _ACT.get(t.i8(4), "NONE"),
        "dilation_d": t.i32(5, 1),
        "dilation_w": t.i32(6, 1),
        "dilation_h": t.i32(7, 1),
    }


def _useq_lstm_options(t: Table) -> Dict[str, Any]:
    return {
        "activation": _ACT.get(t.i8(0), "NONE"),
        "cell_clip": t.f32(1, 0.0),
        "proj_clip": t.f32(2, 0.0),
        "time_major": t.bool_(3),
        "asymmetric_quantize_inputs": t.bool_(4),
    }


def _while_options(t: Table) -> Dict[str, Any]:
    return {
        "cond_subgraph_index": t.i32(0, 0),
        "body_subgraph_index": t.i32(1, 0),
    }


def _if_options(t: Table) -> Dict[str, Any]:
    return {
        "then_subgraph_index": t.i32(0, 0),
        "else_subgraph_index": t.i32(1, 0),
    }


def _pack_options(t: Table) -> Dict[str, Any]:
    return {"values_count": t.i32(0, 0), "axis": t.i32(1, 0)}


def _unpack_options(t: Table) -> Dict[str, Any]:
    return {"num": t.i32(0, 0), "axis": t.i32(1, 0)}


def _squeeze_options(t: Table) -> Dict[str, Any]:
    dims = t.scalar_vector(0, np.int32)
    return {"squeeze_dims": [int(x) for x in dims]}


def _split_options(t: Table) -> Dict[str, Any]:
    return {"num_splits": t.i32(0, 0)}


def _gather_options(t: Table) -> Dict[str, Any]:
    return {"axis": t.i32(0, 0), "batch_dims": t.i32(1, 0)}


def _cast_options(t: Table) -> Dict[str, Any]:
    return {"in_type": t.i8(0, 0), "out_type": t.i8(1, 0)}


def _argmax_options(t: Table) -> Dict[str, Any]:
    return {"output_type": t.i8(0, 2)}


def _shape_options(t: Table) -> Dict[str, Any]:
    return {"out_type": t.i8(0, 2)}


def _mirror_pad_options(t: Table) -> Dict[str, Any]:
    return {"mode": t.i8(0, 0)}


def _l2norm_options(t: Table) -> Dict[str, Any]:
    return {"activation": _ACT.get(t.i8(0), "NONE")}


def _space_to_depth_options(t: Table) -> Dict[str, Any]:
    return {"block_size": t.i32(0, 0)}


def _argmin_options(t: Table) -> Dict[str, Any]:
    return {"output_type": t.i8(0, 2)}


def _one_hot_options(t: Table) -> Dict[str, Any]:
    # the flatbuffer wire default is 0 (field omitted when axis == 0);
    # the op-semantic default -1 is what the CONVERTER writes explicitly
    return {"axis": t.i32(0, 0)}


def _cumsum_options(t: Table) -> Dict[str, Any]:
    return {"exclusive": t.bool_(0), "reverse": t.bool_(1)}


def _lrn_options(t: Table) -> Dict[str, Any]:
    return {
        "radius": t.i32(0, 5),
        "bias": t.f32(1, 1.0),
        "alpha": t.f32(2, 1.0),
        "beta": t.f32(3, 0.5),
    }


_OPTION_PARSERS: Dict[int, Callable[[Table], Dict[str, Any]]] = {
    S.OptionsType.Conv2DOptions: _conv2d_options,
    S.OptionsType.DepthwiseConv2DOptions: _dwconv2d_options,
    S.OptionsType.Pool2DOptions: _pool2d_options,
    S.OptionsType.FullyConnectedOptions: _fc_options,
    S.OptionsType.SoftmaxOptions: _softmax_options,
    S.OptionsType.ConcatenationOptions: _concat_options,
    S.OptionsType.AddOptions: _act_only_options,
    S.OptionsType.MulOptions: _act_only_options,
    S.OptionsType.SubOptions: _act_only_options,
    S.OptionsType.DivOptions: _act_only_options,
    S.OptionsType.L2NormOptions: _l2norm_options,
    S.OptionsType.ReshapeOptions: _reshape_options,
    S.OptionsType.ReducerOptions: _reducer_options,
    S.OptionsType.StridedSliceOptions: _strided_slice_options,
    S.OptionsType.ResizeBilinearOptions: _resize_bilinear_options,
    S.OptionsType.ResizeNearestNeighborOptions: _resize_nn_options,
    S.OptionsType.LeakyReluOptions: _leaky_relu_options,
    S.OptionsType.TransposeConvOptions: _transpose_conv_options,
    S.OptionsType.PackOptions: _pack_options,
    S.OptionsType.UnpackOptions: _unpack_options,
    S.OptionsType.SqueezeOptions: _squeeze_options,
    S.OptionsType.SplitOptions: _split_options,
    S.OptionsType.GatherOptions: _gather_options,
    S.OptionsType.CastOptions: _cast_options,
    S.OptionsType.ArgMaxOptions: _argmax_options,
    S.OptionsType.ShapeOptions: _shape_options,
    S.OptionsType.MirrorPadOptions: _mirror_pad_options,
    S.OptionsType.SpaceToDepthOptions: _space_to_depth_options,
    S.OptionsType.ArgMinOptions: _argmin_options,
    S.OptionsType.OneHotOptions: _one_hot_options,
    S.OptionsType.CumsumOptions: _cumsum_options,
    S.OptionsType.LocalResponseNormalizationOptions: _lrn_options,
    S.OptionsType.UnidirectionalSequenceLSTMOptions: _useq_lstm_options,
    S.OptionsType.WhileOptions: _while_options,
    S.OptionsType.IfOptions: _if_options,
    S.OptionsType.ReverseSequenceOptions: _reverse_sequence_options,
    S.OptionsType.Conv3DOptions: _conv3d_options,
}


def _parse_opcode(t: Table) -> str:
    # schema >= 2.4: builtin_code (slot 3, int32) supersedes the int8
    # deprecated_builtin_code (slot 0) for codes > 127.
    dep = t.i8(S.OperatorCodeF.DEPRECATED_BUILTIN_CODE, 0)
    code = t.i32(S.OperatorCodeF.BUILTIN_CODE, 0)
    code = max(code, dep)
    if code == S.BUILTIN_OP_CODES["CUSTOM"]:
        return "CUSTOM:" + (t.string(S.OperatorCodeF.CUSTOM_CODE) or "?")
    name = S.BUILTIN_OP_NAMES.get(code)
    if name is None:
        return f"UNKNOWN_{code}"
    return name


def _decode_custom_options(raw: bytes) -> Dict[str, Any]:
    """Custom-op options are a flexbuffer-encoded map (the reference
    backend reads them through TFLite's flexbuffers, e.g. the
    detection-postprocess op's NMS knobs), decoded by this package's own
    reader (tflite/flexbuffers.py).  A payload it cannot decode (malformed,
    or of a type the reader does not know) or whose root is not a map
    raises ModelError: the op never runs on options it did not read."""
    if not raw:
        return {}
    from . import flexbuffers

    try:
        decoded = flexbuffers.loads(bytes(raw))
    except Exception as e:  # a malformed payload or a type it does not know
        raise ModelError(f"custom-op options not decoded: {e!r}") from e
    if not isinstance(decoded, dict):
        raise ModelError(
            f"custom-op options are a {type(decoded).__name__}, not a map")
    return decoded


def _parse_quant(t: Optional[Table]) -> Optional[QuantParams]:
    if t is None:
        return None
    scale = t.scalar_vector(S.QuantF.SCALE, np.float32)
    zp = t.scalar_vector(S.QuantF.ZERO_POINT, np.int64)
    if scale.size == 0:
        return None
    return QuantParams(
        scale=np.asarray(scale, dtype=np.float32).copy(),
        zero_point=np.asarray(zp, dtype=np.int32).copy()
        if zp.size
        else np.zeros(scale.size, np.int32),
        quantized_dimension=t.i32(S.QuantF.QUANTIZED_DIMENSION, 0),
    )


def _fold_const_fp16_dequant(tensors, ops):
    """Fold DEQUANTIZE over constant float16 weights into float32
    constants (fp16 post-training quantization stores every weight
    behind a DEQUANTIZE op; TFLite's runtime special-cases this too).
    Runtime DEQUANTIZE of activations / int8 tensors is untouched."""
    kept = []
    for op in ops:
        if op.opname == "DEQUANTIZE" and op.inputs[0] >= 0:
            src = tensors[op.inputs[0]]
            dst = tensors[op.outputs[0]]
            if (
                src.is_constant
                and src.dtype == np.float16
                and dst.quant is None
            ):
                dst.data = src.data.astype(np.float32)
                continue
        kept.append(op)
    if len(kept) != len(ops):
        for i, op in enumerate(kept):
            op.index = i
    return kept


def parse_tflite(
    data: bytes, subgraph_index: int = 0, _wire_subgraphs: bool = True
) -> Graph:
    """Parse the bytes of a ``.tflite`` file into an IR Graph."""
    if len(data) < 8:
        raise ModelError("file too small to be a .tflite model")
    if file_identifier(data) != "TFL3":
        raise ModelError(f"not a TFLite flatbuffer (id={file_identifier(data)!r})")
    model = root_table(data)

    opcodes = [_parse_opcode(t) for t in model.table_vector(S.ModelF.OPERATOR_CODES)]
    versions = [
        t.i32(S.OperatorCodeF.VERSION, 1)
        for t in model.table_vector(S.ModelF.OPERATOR_CODES)
    ]
    buffers = model.table_vector(S.ModelF.BUFFERS)
    subgraphs = model.table_vector(S.ModelF.SUBGRAPHS)
    if subgraph_index >= len(subgraphs):
        raise ModelError(
            f"subgraph {subgraph_index} out of range ({len(subgraphs)} present)"
        )
    sg = subgraphs[subgraph_index]

    tensors: List[TensorDef] = []
    for i, tt in enumerate(sg.table_vector(S.SubGraphF.TENSORS)):
        shape = tuple(int(x) for x in tt.scalar_vector(S.TensorF.SHAPE, np.int32))
        ttype = S.TensorType(tt.i8(S.TensorF.TYPE, 0))
        buf_idx = tt.u32(S.TensorF.BUFFER, 0)
        data_arr: Optional[np.ndarray] = None
        if tt.bool_(S.TensorF.IS_VARIABLE):
            # stateful tensor (RNN/LSTM state): TFLite zero-initializes
            # variable tensors — to the quantization zero POINT for
            # quantized states (real zero); serving is stateless per
            # request, so the state materializes as a constant
            from ..ir.graph import numpy_dtype

            dt = numpy_dtype(ttype)
            q = _parse_quant(tt.table(S.TensorF.QUANTIZATION))
            zp = int(q.zero_point[0]) if q is not None else 0
            data_arr = np.full(shape, zp, dt)
        elif buf_idx and buf_idx < len(buffers):
            raw = buffers[buf_idx].bytes_vector(S.BufferF.DATA)
            if not raw:
                # buffer-offset placement (TF >= 2.13
                # _experimental_use_buffer_offset, mandatory for >2GB
                # models): weights live at (offset, size) in the file
                # bytes, outside the flatbuffer tree
                off = buffers[buf_idx].u64(S.BufferF.OFFSET, 0)
                size = buffers[buf_idx].u64(S.BufferF.SIZE, 0)
                if off > 1 and size > 0:  # offset 1 is the sentinel
                    raw = data[off: off + size]
            if raw:
                from ..ir.graph import numpy_dtype

                dt = numpy_dtype(ttype)
                arr = np.frombuffer(raw, dtype=dt)
                if shape:
                    arr = arr.reshape(shape)
                data_arr = arr
        tensors.append(
            TensorDef(
                index=i,
                name=tt.string(S.TensorF.NAME) or f"t{i}",
                shape=shape,
                ttype=ttype,
                quant=_parse_quant(tt.table(S.TensorF.QUANTIZATION)),
                data=data_arr,
            )
        )

    ops: List[OpNode] = []
    for i, ot in enumerate(sg.table_vector(S.SubGraphF.OPERATORS)):
        opcode_index = ot.u32(S.OperatorF.OPCODE_INDEX, 0)
        opname = opcodes[opcode_index]
        opts_type = ot.u8(S.OperatorF.BUILTIN_OPTIONS_TYPE, 0)
        options: Dict[str, Any] = {}
        parser = _OPTION_PARSERS.get(opts_type)
        if parser is not None:
            opt_table = ot.union(S.OperatorF.BUILTIN_OPTIONS)
            if opt_table is not None:
                options = parser(opt_table)
        if opname.startswith("CUSTOM:"):
            options = _decode_custom_options(
                ot.bytes_vector(S.OperatorF.CUSTOM_OPTIONS)
            )
        ops.append(
            OpNode(
                index=i,
                opname=opname,
                inputs=[int(x) for x in ot.scalar_vector(S.OperatorF.INPUTS, np.int32)],
                outputs=[
                    int(x) for x in ot.scalar_vector(S.OperatorF.OUTPUTS, np.int32)
                ],
                options=options,
                version=versions[opcode_index],
            )
        )

    ops = _fold_const_fp16_dequant(tensors, ops)
    g = Graph(
        name=sg.string(S.SubGraphF.NAME) or "main",
        tensors=tensors,
        ops=ops,
        inputs=[int(x) for x in sg.scalar_vector(S.SubGraphF.INPUTS, np.int32)],
        outputs=[int(x) for x in sg.scalar_vector(S.SubGraphF.OUTPUTS, np.int32)],
        description=model.string(S.ModelF.DESCRIPTION) or "",
        version=model.u32(S.ModelF.VERSION, 3),
    )
    if _wire_subgraphs and any(
        op.opname in ("WHILE", "IF", "CALL_ONCE") for op in ops
    ):
        # control-flow ops reference sibling subgraphs by index: parse
        # them all once and share the list so nested control flow works
        shared = [
            g if i == subgraph_index
            else parse_tflite(data, i, _wire_subgraphs=False)
            for i in range(len(subgraphs))
        ]
        for child in shared:
            child.subgraphs = shared
    return g


def parse_tflite_file(path: str, subgraph_index: int = 0) -> Graph:
    with open(path, "rb") as f:
        return parse_tflite(f.read(), subgraph_index)
