"""Subgraph -> runnable PyTorch program.

Given an IR graph and a set of op indices, computes the subgraph I/O
boundary, prepares host-side parameters (weight layouts, folded
zero-point corrections, fixed-point multipliers), and produces a
function ``fn(params, inputs) -> outputs`` over torch tensors that runs
the ops in order, eagerly.

A program with a WHILE or an IF reads a value on the host while it
runs (ops/lowerings.py): it is not ``capturable``, and no CUDA graph
holds it (backend/executor.py ``build_combo``).

A program prepared for a host (CPU) worker may also hold custom ops
with a host implementation (ops/host_ops.py, e.g. SSD's detection
post-process): they run as numpy functions between the PyTorch ops,
CPU tensors in and out (band_tpu's ``_build_custom_program`` and
``_execute_eager``, backend/executor.py:151-177, :374-400).

Graph-op spans: while a torch.profiler session runs (on any thread) or
the job tracer is on, each op runs inside ``span("opNNN_NAME")``
(tracing/spans.py), the counterpart of band_tpu's ``jax.named_scope``
(band_tpu/backend/program.py:163-167), which tools/xprof_summary.py
reads to attribute each kernel to its graph op.  The gate is read once
per call, so a call made with neither on enters no span; a CUDA graph's
capture (``spans_off``) enters none either.

Counterpart: band_tpu/backend/program.py, which builds a function for
``jax.jit``; here there is nothing to trace or compile and no fusion
barriers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..errors import LoweringError
from ..ir.graph import Graph
from ..ops.host_ops import has_host_impl, run_host_op
from ..ops.lowerings import (CONTROL_FLOW, LowerCtx, request_free,
                             require_ieee_fp32, shard_params)
from ..ops.registry import REGISTRY, get_lowering
from ..tracing.spans import active, span, spans_off  # noqa: F401


def subgraph_boundary(
    graph: Graph, op_indices: Sequence[int]
) -> Tuple[List[int], List[int]]:
    """Compute (input tensor ids, output tensor ids) of an op subset.

    Inputs: non-constant tensors consumed inside but not produced inside.
    Outputs: tensors produced inside that are graph outputs or are
    consumed by ops outside the subset (reference semantics:
    band/model_spec.h:43-52 GetPureInputTensors/GetOutputTensors).
    """
    ops = set(op_indices)
    produced = set()
    consumed: List[int] = []
    for oi in op_indices:
        for t in graph.ops[oi].outputs:
            produced.add(t)
    seen = set()
    for oi in sorted(op_indices):
        for t in graph.ops[oi].inputs:
            if t < 0 or t in seen:
                continue
            seen.add(t)
            td = graph.tensor(t)
            if td.is_constant or t in produced:
                continue
            consumed.append(t)
    outside_consumed = set()
    for op in graph.ops:
        if op.index in ops:
            continue
        for t in op.inputs:
            if t >= 0:
                outside_consumed.add(t)
    outputs = []
    for oi in sorted(op_indices):
        for t in graph.ops[oi].outputs:
            if (t in graph.outputs or t in outside_consumed) and t not in outputs:
                outputs.append(t)
    return consumed, outputs


def prepare_params(
    graph: Graph, op_indices: Sequence[int], exact: bool = True
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Host-side parameter preparation for every op in the subgraph:
    numpy arrays go to ``params``, scalars to ``meta``."""
    params: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    for oi in op_indices:
        op = graph.ops[oi]
        low = get_lowering(op.opname)
        if low.prepare is not None:
            out = low.prepare(graph, op, exact)
            for k, v in out.items():
                key = f"op{op.index}/{k}"
                if isinstance(v, np.ndarray):
                    params[key] = v
                else:
                    meta[key] = v
        else:
            for pos, tid in enumerate(op.inputs):
                if tid < 0 or pos in low.static_inputs:
                    continue
                td = graph.tensor(tid)
                if td.is_constant and f"t{tid}" not in params:
                    params[f"t{tid}"] = np.ascontiguousarray(td.data)
    return params, meta


def params_from_jax(params: Dict[str, np.ndarray],
                    device=None) -> Dict[str, torch.Tensor]:
    """Contiguous torch tensors (on ``device``, default the CPU) of a
    prepared parameter dict: this package's own ``prepare_params``
    output or band_tpu's ``SubgraphProgram.params`` (numpy in both)."""
    return {
        k: torch.from_numpy(np.array(v, order="C", copy=True)).to(
            device or "cpu")
        for k, v in params.items()
    }


def sharded_params_from_jax(graph: Graph, params: Dict[str, np.ndarray],
                            meta: Dict[str, Any], op_index: int, c0: int,
                            c1: int, device=None):
    """The sharded form of ``params_from_jax``: the tensors (on
    ``device``) and meta overrides of op ``op_index``'s shard computing
    output channels [c0, c1), from prepared params in numpy (this
    package's or band_tpu's; ops/lowerings.py shard_params)."""
    own, over = shard_params(graph, graph.ops[op_index], params, meta, c0, c1)
    return params_from_jax(own, device), over


@dataclass
class SubgraphProgram:
    """A prepared, runnable subgraph."""

    graph: Graph
    op_indices: Tuple[int, ...]
    input_ids: Tuple[int, ...]
    output_ids: Tuple[int, ...]
    params: Dict[str, np.ndarray]
    meta: Dict[str, Any]
    # holds a host op: runs on a host worker, one request at a time
    has_custom: bool = False
    # may be captured into a CUDA graph: False where an op reads a value
    # on the host (a WHILE's condition, an IF's predicate)
    capturable: bool = True

    @property
    def input_specs(self):
        return [
            (self.graph.tensor(t).shape, self.graph.tensor(t).dtype)
            for t in self.input_ids
        ]

    @property
    def output_specs(self):
        return [
            (self.graph.tensor(t).shape, self.graph.tensor(t).dtype)
            for t in self.output_ids
        ]

    def make_fn(self, run_op=None):
        """Function (params, inputs) -> outputs over torch tensors.  The
        inputs may hold a window of requests stacked on their leading
        axis (ops/lowerings.py); the outputs then do too.  ``run_op(ctx,
        op)``, where given, runs an op in place of its lowering when it
        returns True (a mesh's shards, parallel/mesh.py).  While a
        profile runs or the job tracer is on (``active``, read once a
        call), each op runs in a span named opNNN_NAME."""
        graph = self.graph
        op_indices = self.op_indices
        input_ids = self.input_ids
        output_ids = self.output_ids
        meta = self.meta
        free = request_free(graph)
        names = {oi: f"op{oi:03d}_{graph.ops[oi].opname}"
                 for oi in op_indices}

        def run(ctx, op):
            if run_op is not None and run_op(ctx, op):
                return
            if op.is_custom:
                _run_custom(ctx, op)
            else:
                get_lowering(op.opname).trace(ctx, op)

        def fn(params, inputs):
            batch = window_size(graph, input_ids, inputs, free)
            ctx = LowerCtx(graph, params, meta, batch=batch, free=free)
            for tid, v in zip(input_ids, inputs):
                ctx.set(tid, v)
            if active():
                for oi in op_indices:
                    with span(names[oi]):
                        run(ctx, graph.ops[oi])
            else:
                for oi in op_indices:
                    run(ctx, graph.ops[oi])
            return [ctx.arr(t) for t in output_ids]

        return fn

    @property
    def output_free(self) -> Tuple[bool, ...]:
        """Per output, whether it carries no request axis (a SHAPE or RANK
        value): one value for every request of a window."""
        free = request_free(self.graph)
        return tuple(t in free for t in self.output_ids)


def window_size(graph: Graph, input_ids: Sequence[int],
                inputs: Sequence[torch.Tensor], free=frozenset()) -> int:
    """How many requests the inputs stack: a per-request input of model
    shape [d0, ...] arrives as [B*d0, ...] (a scalar as [B])."""
    for tid, v in zip(input_ids, inputs):
        shape = graph.tensor(tid).shape
        if tid in free:
            continue
        if not shape:
            return max(int(v.numel()), 1)
        if int(shape[0]) > 0 and v.dim():
            return max(int(v.shape[0]) // int(shape[0]), 1)
    return 1


def _run_custom(ctx: LowerCtx, op) -> None:
    """One host op: its inputs leave torch as numpy arrays and its
    outputs come back as CPU tensors.  ``Tensor.numpy`` raises on a
    card's tensor, so a host op never runs on a GPU worker's data."""
    ins = [ctx.arr(t).numpy() for t in op.inputs if t >= 0]
    outs = run_host_op(op.opname, ctx.graph, op, ins)
    for tid, o in zip(op.outputs, outs):
        ctx.set(tid, torch.from_numpy(np.ascontiguousarray(o)))


def build_program(
    graph: Graph, op_indices: Sequence[int], exact: bool = True,
    host: bool = False, device=None,
) -> SubgraphProgram:
    """A program over ``op_indices``.  ``host`` (a host worker's program)
    admits custom ops with a host implementation; on any other worker a
    custom op raises LoweringError.  For a card (``device`` a CUDA
    device) a float32 contraction is refused while TF32 is on
    (ops/lowerings.py require_ieee_fp32)."""
    custom = [oi for oi in op_indices if graph.ops[oi].is_custom]
    if custom and not host:
        raise LoweringError("custom ops can only be prepared on host workers")
    missing = sorted(
        {
            graph.ops[oi].opname
            for oi in op_indices
            if (not has_host_impl(graph.ops[oi].opname)
                if graph.ops[oi].is_custom
                else graph.ops[oi].opname not in REGISTRY)
        }
    )
    if missing:
        raise LoweringError(f"unsupported ops in subgraph: {missing}")
    if device is not None and torch.device(device).type == "cuda":
        require_ieee_fp32(graph, op_indices)
    op_indices = tuple(sorted(op_indices))
    inputs, outputs = subgraph_boundary(graph, op_indices)
    params, meta = prepare_params(
        graph, [oi for oi in op_indices if oi not in custom], exact
    )
    # custom ops read their constant inputs (e.g. SSD anchors) as plain
    # params; prepare_params only covered the lowered ops
    for oi in custom:
        for tid in graph.ops[oi].inputs:
            if tid >= 0 and graph.tensor(tid).is_constant:
                params.setdefault(
                    f"t{tid}", np.ascontiguousarray(graph.tensor(tid).data)
                )
    return SubgraphProgram(
        graph=graph,
        op_indices=op_indices,
        input_ids=tuple(inputs),
        output_ids=tuple(outputs),
        params=params,
        meta=meta,
        has_custom=bool(custom),
        capturable=not any(graph.ops[oi].opname in CONTROL_FLOW
                           for oi in op_indices),
    )
