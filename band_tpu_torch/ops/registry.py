"""Lowering registry: maps TFLite builtin op names to PyTorch lowerings.

Each op has:
  * a ``trace`` function that runs the op on torch tensors,
  * an optional ``prepare`` function run once host-side at subgraph
    preparation time (weight re-layout, folded zero-point corrections,
    fixed-point multiplier decomposition),
  * a set of input positions that are consumed statically (shape
    tensors, permutations, pad amounts, ...) and must never become
    runtime parameters.

This mirrors the role of TFLite's kernel registry behind the
reference's executor (band/backend/tfl/model_executor.cc:173-192) but
runs eager PyTorch code and hand-written CUDA kernels instead of
interpreter nodes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, Optional

from ..errors import LoweringError


@dataclass(frozen=True)
class Lowering:
    name: str
    trace: Callable  # (ctx, op) -> None (writes outputs via ctx.set)
    prepare: Optional[Callable] = None  # (graph, op, exact) -> Dict[str, Any]
    static_inputs: FrozenSet[int] = frozenset()


REGISTRY: Dict[str, Lowering] = {}


def register(name: str, prepare: Optional[Callable] = None,
             static_inputs=()):  # decorator
    def deco(fn: Callable) -> Callable:
        REGISTRY[name] = Lowering(
            name=name,
            trace=fn,
            prepare=prepare,
            static_inputs=frozenset(static_inputs),
        )
        return fn

    return deco


def get_lowering(opname: str) -> Lowering:
    low = REGISTRY.get(opname)
    if low is None:
        raise LoweringError(f"no lowering registered for op {opname}")
    return low


def is_supported(opname: str) -> bool:
    return opname in REGISTRY
