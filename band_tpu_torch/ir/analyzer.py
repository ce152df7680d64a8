"""ModelAnalyzer: partitions a model into unit subgraphs and per-worker
executable subgraph definitions.

Re-implements the *algorithms* of the reference's analyzer
(band/model_analyzer.cc:256-883) against the IR:
  * unit subgraphs: maximal op groups with identical supported-worker
    sets, grown by frontier expansion over resolved tensors
    (model_analyzer.cc:367-618, core loop 478-538)
  * merged subgraphs: contiguous unit ranges whose external dependencies
    are satisfied by preceding units (closure test, :799-883)
  * fallback partitioning: per worker, alternate device/host segments
    around unsupported ops (:627-789)

"Supported" here means: the op has a PyTorch lowering (ops/lowerings.py)
for the worker's device; host (CPU) workers additionally run custom ops
with host implementations (ops/host_ops.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ..common import SubgraphPreparationType
from ..config import SubgraphConfig
from ..errors import ModelError
from ..ops.registry import is_supported
from .graph import Graph
from .model_spec import ModelSpec, compute_unit_dependencies


@dataclass(frozen=True)
class SubgraphDef:
    """One executable subgraph definition (reference:
    band/model_analyzer.h:15-21)."""

    worker_id: int
    op_indices: FrozenSet[int]
    unit_indices: FrozenSet[int]

    def __str__(self) -> str:
        return (f"w{self.worker_id}:units[{','.join(map(str, sorted(self.unit_indices)))}]"
                f"({len(self.op_indices)} ops)")


def op_supported_on_worker(graph: Graph, op_index: int, is_host: bool) -> bool:
    op = graph.ops[op_index]
    if op.is_custom:
        # custom ops (e.g. detection post-process) only run on host workers
        from ..ops.host_ops import has_host_impl

        return is_host and has_host_impl(op.opname)
    return is_supported(op.opname)


def build_model_spec(
    graph: Graph, worker_is_host: Sequence[bool]
) -> ModelSpec:
    """Probe op support per worker and derive unit subgraphs."""
    spec = ModelSpec(graph=graph)
    for wid, is_host in enumerate(worker_is_host):
        bad = {
            oi
            for oi in range(len(graph.ops))
            if not op_supported_on_worker(graph, oi, is_host)
        }
        spec.unsupported_ops[wid] = bad

    units = derive_unit_subgraphs(graph, spec, len(worker_is_host))
    spec.unit_subgraph_ops = units
    spec.unit_dependencies = compute_unit_dependencies(graph, units)
    return spec


def _support_mask(spec: ModelSpec, num_workers: int, op_index: int) -> int:
    mask = 0
    for wid in range(num_workers):
        if spec.is_op_supported(wid, op_index):
            mask |= 1 << wid
    return mask


def derive_unit_subgraphs(
    graph: Graph, spec: ModelSpec, num_workers: int
) -> List[FrozenSet[int]]:
    """Maximal groups of dependency-ready ops sharing a support mask.

    Greedy frontier expansion (reference core loop
    model_analyzer.cc:478-538): repeatedly pick the first topologically
    ready op, then absorb every op that becomes ready and has the same
    supported-worker mask.
    """
    n = len(graph.ops)
    masks = [_support_mask(spec, num_workers, oi) for oi in range(n)]
    if any(m == 0 for m in masks):
        bad = [graph.ops[i].opname for i in range(n) if masks[i] == 0]
        raise ModelError(f"ops unsupported on every worker: {sorted(set(bad))}")

    resolved: Set[int] = set()
    for t in graph.inputs:
        resolved.add(t)
    remaining = set(range(n))

    def ready(oi: int) -> bool:
        return all(
            t < 0 or graph.tensor(t).is_constant or t in resolved
            for t in graph.ops[oi].inputs
        )

    units: List[FrozenSet[int]] = []
    while remaining:
        ready_ops = [oi for oi in remaining if ready(oi)]
        if not ready_ops:
            # an op consumes a tensor nothing produces (malformed or
            # truncated model): surface it as a model error, not an
            # opaque min() crash
            oi = min(remaining)
            raise ModelError(
                f"op {oi} ({graph.ops[oi].opname}) depends on tensors no "
                "op produces; the graph is not executable"
            )
        seed = min(ready_ops)
        mask = masks[seed]
        unit: Set[int] = set()
        changed = True
        while changed:
            changed = False
            for oi in sorted(remaining):
                if masks[oi] == mask and ready(oi):
                    unit.add(oi)
                    remaining.discard(oi)
                    for t in graph.ops[oi].outputs:
                        resolved.add(t)
                    changed = True
        units.append(frozenset(unit))
    return units


# Merge validity (the reference's closure check, model_analyzer.cc:
# 799-883) holds by construction here: derive_unit_subgraphs only emits
# an op once its producers are absorbed, so every unit dependency points
# to a strictly EARLIER unit — any contiguous range [lo..hi] therefore
# only depends on units < lo or inside the range.  The invariant is
# asserted once per model in build_model_spec rather than re-scanned per
# candidate range.


class ModelAnalyzer:
    """Produces SubgraphDefs for one model across the worker pool."""

    def __init__(
        self,
        graph: Graph,
        spec: ModelSpec,
        num_workers: int,
        config: SubgraphConfig,
        need_fallback_subgraphs: bool,
    ):
        self.graph = graph
        self.spec = spec
        self.num_workers = num_workers
        self.config = config
        self.need_fallback = need_fallback_subgraphs

    def create_subgraphs(self) -> List[SubgraphDef]:
        prep = self.config.subgraph_preparation_type
        if not self.need_fallback and prep != SubgraphPreparationType.UNIT_SUBGRAPH:
            prep = SubgraphPreparationType.NO_FALLBACK_SUBGRAPH
        if prep == SubgraphPreparationType.NO_FALLBACK_SUBGRAPH:
            defs = self._no_fallback()
        elif prep == SubgraphPreparationType.UNIT_SUBGRAPH:
            defs = self._units_only()
        elif prep == SubgraphPreparationType.MERGE_UNIT_SUBGRAPH:
            defs = self._merged_units()
        elif prep == SubgraphPreparationType.FALLBACK_PER_WORKER:
            defs = self._fallback_per_worker()
        else:
            raise ModelError(f"unknown preparation type {prep}")
        if not defs:
            raise ModelError("no worker can execute this model")
        return defs

    # --- strategies ---

    def _all_units(self) -> FrozenSet[int]:
        return frozenset(range(self.spec.num_unit_subgraphs))

    def _no_fallback(self) -> List[SubgraphDef]:
        """Whole model on every worker that supports every op
        (reference: model_analyzer.cc:268-285)."""
        all_ops = frozenset(range(self.spec.num_ops))
        defs = []
        for wid in range(self.num_workers):
            if self.spec.worker_supports_all(wid):
                defs.append(SubgraphDef(wid, all_ops, self._all_units()))
        return defs

    def _units_only(self) -> List[SubgraphDef]:
        defs = []
        for wid in range(self.num_workers):
            for ui in self.spec.units_supported_by(wid):
                defs.append(
                    SubgraphDef(
                        wid,
                        self.spec.unit_subgraph_ops[ui],
                        frozenset([ui]),
                    )
                )
        return defs

    def _merged_units(self) -> List[SubgraphDef]:
        """Units plus every valid contiguous merge on each worker
        (reference: model_analyzer.cc:799-883).  Pruned by
        minimum_subgraph_size: units smaller than the threshold only
        appear inside merges unless they are the only option."""
        num_units = self.spec.num_unit_subgraphs
        defs: List[SubgraphDef] = []
        seen: Set[Tuple[int, FrozenSet[int]]] = set()
        for wid in range(self.num_workers):
            supported = self.spec.units_supported_by(wid)
            for lo in range(num_units):
                if lo not in supported:
                    continue
                ops: Set[int] = set()
                for hi in range(lo, num_units):
                    if hi not in supported:
                        break
                    ops |= self.spec.unit_subgraph_ops[hi]
                    small = (
                        len(ops) < self.config.minimum_subgraph_size
                        and not (lo == 0 and hi == num_units - 1)
                        and num_units > 1
                        and lo != hi  # single units always kept as anchors
                    )
                    if small:
                        continue
                    key = (wid, frozenset(range(lo, hi + 1)))
                    if key in seen:
                        continue
                    seen.add(key)
                    defs.append(
                        SubgraphDef(wid, frozenset(ops), key[1])
                    )
        return defs

    def _fallback_per_worker(self) -> List[SubgraphDef]:
        """FALLBACK_PER_WORKER resolves to the merged-unit machinery.

        The reference's GetSubgraphsForFallbackOps
        (model_analyzer.cc:627-789) emits, per worker, alternating
        device/CPU segments around that worker's unsupported ops.  Here
        units are by construction the maximal support-equivalent op
        groups, so the merged contiguous unit ranges per worker ARE
        exactly those segments (a worker's supported stretch between two
        unsupported units is one merged range; the unsupported stretch
        is the host workers' range) — one mechanism covers both modes."""
        return list(self._merged_units())
