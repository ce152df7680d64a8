"""ModelSpec: static per-model graph facts used by partitioning and
scheduling (reference: band/model_spec.h:43-58, band/model_spec.cc).

Holds op<->tensor adjacency, per-worker op support, unit-subgraph
assignments and the unit dependency relation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

from .graph import Graph


@dataclass
class ModelSpec:
    graph: Graph
    # per-worker set of unsupported op indices (reference: ModelSpec
    # unsupported_ops, filled by delegate probing; here by registry probing)
    unsupported_ops: Dict[int, Set[int]] = field(default_factory=dict)
    # unit subgraph op sets, in topological order
    unit_subgraph_ops: List[FrozenSet[int]] = field(default_factory=list)
    # unit_dependencies[i] = set of unit indices unit i depends on
    unit_dependencies: List[FrozenSet[int]] = field(default_factory=list)

    @property
    def num_ops(self) -> int:
        return len(self.graph.ops)

    @property
    def num_unit_subgraphs(self) -> int:
        return len(self.unit_subgraph_ops)

    def op_input_tensors(self, op_index: int) -> List[int]:
        return [
            t
            for t in self.graph.ops[op_index].inputs
            if t >= 0 and not self.graph.tensor(t).is_constant
        ]

    def op_output_tensors(self, op_index: int) -> List[int]:
        return list(self.graph.ops[op_index].outputs)

    def is_op_supported(self, worker_id: int, op_index: int) -> bool:
        return op_index not in self.unsupported_ops.get(worker_id, set())

    def worker_supports_all(self, worker_id: int) -> bool:
        return not self.unsupported_ops.get(worker_id, set())

    def unit_deps_mask(self, unit_index: int) -> int:
        mask = 0
        for d in self.unit_dependencies[unit_index]:
            mask |= 1 << d
        return mask

    def units_supported_by(self, worker_id: int) -> Set[int]:
        bad = self.unsupported_ops.get(worker_id, set())
        return {
            i
            for i, ops in enumerate(self.unit_subgraph_ops)
            if not (ops & bad)
        }


def compute_unit_dependencies(
    graph: Graph, units: Sequence[FrozenSet[int]]
) -> List[FrozenSet[int]]:
    """unit i depends on unit j if some op of i consumes a tensor some op
    of j produces (reference: ModelSpec::GetUnitSubgraphDependency)."""
    producer_unit: Dict[int, int] = {}
    for ui, ops in enumerate(units):
        for oi in ops:
            for t in graph.ops[oi].outputs:
                producer_unit[t] = ui
    deps: List[Set[int]] = [set() for _ in units]
    for ui, ops in enumerate(units):
        for oi in ops:
            for t in graph.ops[oi].inputs:
                if t < 0 or graph.tensor(t).is_constant:
                    continue
                pu = producer_unit.get(t)
                if pu is not None and pu != ui:
                    deps[ui].add(pu)
    # transitive closure so schedulers can test "all deps resolved" cheaply
    changed = True
    while changed:
        changed = False
        for ui in range(len(units)):
            extra = set()
            for d in deps[ui]:
                extra |= deps[d]
            if not extra <= deps[ui]:
                deps[ui] |= extra
                changed = True
    # topological invariant the merge machinery relies on: every
    # dependency points to a strictly earlier unit (derive_unit_subgraphs
    # only emits an op once its producers are absorbed), so any
    # contiguous unit range is closed under its dependencies
    for ui, d in enumerate(deps):
        assert all(x < ui for x in d), (
            f"unit {ui} depends on a later unit: {sorted(d)}"
        )
    return [frozenset(d) for d in deps]
