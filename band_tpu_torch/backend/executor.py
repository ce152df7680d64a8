"""ModelExecutor: per-(model, worker) cache of prepared subgraph
programs with device-resident weights.

Counterpart of band_tpu/backend/executor.py (itself the analogue of the
reference's per-subgraph interpreter map, band/backend/tfl/
model_executor.cc:327-373).  PrepareSubgraph builds a SubgraphProgram
and moves its parameters to the worker's ``torch.device`` once;
ExecuteSubgraph launches the ops on the calling thread's current stream
and returns device tensors without waiting for them.

Continuous batching stacks a window's requests on the leading axis of
every input (a hand-written kernel has no vmap rule) after padding the
window to the next power of two with copies of its first request, so
a subgraph runs at log2(max_batch) + 1 batch sizes; outputs are split
back per request.  ``exact=False`` builds the programs with the fast
numerics epilogues.  No mesh path, no custom-op path.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import SubgraphKey
from ..errors import ExecutionError
from ..ir.graph import Graph
from .program import SubgraphProgram, build_program, params_from_jax


def to_device(v, device: torch.device) -> torch.Tensor:
    """A host array or tensor as a tensor on ``device``.  Host data bound
    for a card goes through pinned memory with a non-blocking copy, so
    the calling thread never waits for work already queued on the
    stream."""
    if isinstance(v, torch.Tensor):
        t = v
    else:
        t = torch.from_numpy(np.ascontiguousarray(v))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class ModelExecutor:
    """Holds prepared programs for one model on one worker."""

    def __init__(
        self,
        model_id: int,
        graph: Graph,
        worker_id: int,
        device: torch.device,
        exact: bool = True,
    ):
        self.model_id = model_id
        self.graph = graph
        self.worker_id = worker_id
        self.device = torch.device(device)
        # numerics: True reproduces the TFLite interpreter bit for bit;
        # False prepares the float32 epilogues of fast numerics
        self.exact = exact
        self._lock = threading.Lock()
        self._programs: Dict[SubgraphKey, SubgraphProgram] = {}
        self._fns: Dict[SubgraphKey, object] = {}
        self._params: Dict[SubgraphKey, Dict[str, torch.Tensor]] = {}
        # (key, bucket) pairs that have completed at least once; the
        # first run of a bucket builds the CUDA kernels if nothing has
        # yet, and the engine's bucket warm-up reads these
        self._warm: set = set()
        self._warm_max: Dict[SubgraphKey, int] = {}
        # bucket -> launch sequences run (1 = a single request)
        self.windows: collections.Counter = collections.Counter()
        # concurrent prepare_subgraph calls for the same key: the first
        # caller builds, the others wait on its event
        self._preparing: Dict[SubgraphKey, threading.Event] = {}

    # ------------------------------------------------------------------
    def prepare_subgraph(
        self, op_indices: Sequence[int], unit_indices: Sequence[int]
    ) -> SubgraphKey:
        key = SubgraphKey(
            model_id=self.model_id,
            worker_id=self.worker_id,
            unit_indices=frozenset(unit_indices),
        )
        while True:
            with self._lock:
                if key in self._programs:
                    return key
                waiter = self._preparing.get(key)
                if waiter is None:
                    self._preparing[key] = threading.Event()
                    break
            waiter.wait(timeout=600)
        try:
            prog = build_program(self.graph, op_indices, exact=self.exact)
            # weights move to the worker's device once, here
            params = params_from_jax(prog.params, self.device)
            with self._lock:
                self._programs[key] = prog
                self._fns[key] = prog.make_fn()
                self._params[key] = params
        finally:
            with self._lock:
                ev = self._preparing.pop(key, None)
            if ev is not None:
                ev.set()
        return key

    # ------------------------------------------------------------------
    def program(self, key: SubgraphKey) -> SubgraphProgram:
        return self._programs[key]

    def input_ids(self, key: SubgraphKey) -> Tuple[int, ...]:
        return self._programs[key].input_ids

    def output_ids(self, key: SubgraphKey) -> Tuple[int, ...]:
        return self._programs[key].output_ids

    def largest_subgraph_key(self) -> Optional[SubgraphKey]:
        """Key covering the most ops (reference:
        IModelExecutor::GetLargestSubgraphKey)."""
        best, best_n = None, -1
        for key, prog in self._programs.items():
            if len(prog.op_indices) > best_n:
                best, best_n = key, len(prog.op_indices)
        return best

    # ------------------------------------------------------------------
    def _run(self, key: SubgraphKey, args: List[torch.Tensor]):
        with torch.inference_mode():
            return self._fns[key](self._params[key], args)

    def execute(
        self, key: SubgraphKey, inputs: Sequence
    ) -> List[torch.Tensor]:
        """Launch the subgraph on one request.  Returns device tensors
        that may not be computed yet: synchronise the stream (or an
        event recorded on it) before reading them on the host."""
        if key not in self._programs:
            raise ExecutionError(f"subgraph {key} not prepared")
        out = self._run(key, [to_device(v, self.device) for v in inputs])
        self._mark_warm(key, 1)
        return out

    def _mark_warm(self, key: SubgraphKey, bucket: int) -> None:
        self.windows[bucket] += 1
        self._warm.add((key, bucket))
        if bucket > self._warm_max.get(key, 1):
            self._warm_max[key] = bucket

    def max_warm_bucket(self, key: SubgraphKey) -> int:
        """Largest bucket that has completed at least once (1 if only
        single-request dispatches have run)."""
        return self._warm_max.get(key, 1)

    def is_warm(self, key: SubgraphKey, batch: int) -> bool:
        """Has the (key, bucket) program completed at least once?"""
        bucket = 1 if batch <= 1 else 1 << (batch - 1).bit_length()
        return (key, bucket) in self._warm

    def execute_batched(
        self, key: SubgraphKey, inputs_batch: Sequence[Sequence]
    ) -> List[List[torch.Tensor]]:
        """Run B same-subgraph requests as one launch sequence with the
        requests stacked on the leading axis, the window padded to the
        next power of two with its first request.  Returns per-request
        output lists."""
        B = len(inputs_batch)
        if B == 1:
            return [self.execute(key, inputs_batch[0])]
        if key not in self._programs:
            raise ExecutionError(f"subgraph {key} not prepared")
        bucket = 1 << (B - 1).bit_length()
        padded = list(inputs_batch) + [inputs_batch[0]] * (bucket - B)
        args = []
        for pos in range(len(padded[0])):
            col = [ins[pos] for ins in padded]
            if all(isinstance(v, np.ndarray) for v in col):
                # one host-side stack, one copy to the device
                args.append(to_device(np.concatenate(col, axis=0),
                                      self.device))
            else:
                args.append(torch.cat(
                    [to_device(v, self.device) for v in col], dim=0))
        outs = self._run(key, args)
        self._mark_warm(key, bucket)
        split = [torch.split(o, o.shape[0] // bucket, dim=0) for o in outs]
        return [[parts[b] for parts in split] for b in range(B)]
