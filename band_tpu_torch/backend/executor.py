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
numerics epilogues.  On a host worker (``host=True``) a subgraph may
hold custom ops (backend/program.py); such a program takes one request
at a time, so its windows run request by request.

Mesh workers (``mesh``: a dp x tp grid, parallel/mesh.py): a subgraph is
a ShardedProgram, its weights split over "tp" once at preparation and a
window split over "dp" where its size divides (band_tpu/backend/
executor.py:120-135, :339-348).  The executor's ``device`` is the mesh's
lead device in this process, where inputs are staged and outputs land.
A mesh spanning processes launches through the SPMD control plane
(``_spmd``, set by ``SpmdChannel.attach`` on the leader, parallel/
spmd.py): every window is announced to the other processes, which replay
it, before it runs here.  Mesh programs are never captured into a
co-dispatch CUDA graph (``build_combo`` refuses them).

Co-dispatch: ``build_combo`` makes the combined program of a model mix,
several (subgraph, bucket) windows served as one dispatch, and
``run_combo`` serves it.  On a card the combo is one CUDA graph that
captured every member's stacked launch sequence over static input
buffers (band_tpu jits one XLA program per mix, runtime/engine.py
:859-868); on the CPU it is the members' programs run back to back.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import SubgraphKey, bucket_of
from ..errors import ExecutionError
from ..ir.graph import Graph
from ..ops.quant import torch_dtype
from ..tracing import counters
from ..tracing.spans import span, spans_off
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
        host: bool = False,
        mesh=None,
    ):
        self.model_id = model_id
        self.graph = graph
        self.worker_id = worker_id
        # a mesh worker's grid (parallel/mesh.py Mesh), else None; its
        # lead device in this process stands for the worker's device
        self.mesh = mesh
        self.device = torch.device(device)
        # set on the leader by SpmdChannel.attach() for a mesh spanning
        # processes: every launch is announced to the followers first
        self._spmd = None
        # numerics: True reproduces the TFLite interpreter bit for bit;
        # False prepares the float32 epilogues of fast numerics
        self.exact = exact
        # a host worker's executor: its programs may hold custom ops
        self.host = host
        self._lock = threading.Lock()
        self._programs: Dict[SubgraphKey, SubgraphProgram] = {}
        self._fns: Dict[SubgraphKey, object] = {}
        self._params: Dict[SubgraphKey, Dict[str, torch.Tensor]] = {}
        self._free: Dict[SubgraphKey, Tuple[bool, ...]] = {}
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
            prog = build_program(self.graph, op_indices, exact=self.exact,
                                 host=self.host, device=self.device)
            # weights move to the worker's device(s) once, here
            if self.mesh is not None:
                from ..parallel.mesh import ShardedProgram

                sp = ShardedProgram(prog, self.mesh)
                fn, params = sp.run, sp.params
            else:
                fn = prog.make_fn()
                params = params_from_jax(prog.params, self.device)
            with self._lock:
                self._programs[key] = prog
                self._fns[key] = fn
                self._params[key] = params
                self._free[key] = prog.output_free
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
        if self._spmd is not None:
            out = self._spmd.run_window(self, key, [list(inputs)])[0]
        else:
            with span("band.stage"):
                args = [to_device(v, self.device) for v in inputs]
            out = self._run(key, args)
        self._mark_warm(key, 1)
        return out

    def _mark_warm(self, key: SubgraphKey, bucket: int,
                   window: bool = True) -> None:
        if window:
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
        return (key, bucket_of(batch)) in self._warm

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
        bucket = bucket_of(B)
        if self._programs[key].has_custom:
            # host ops take one request at a time (the SSD post-process
            # flattens its inputs): the window runs request by request
            out = [self.execute(key, ins) for ins in inputs_batch]
            self._mark_warm(key, bucket, window=False)
            return out
        if self._spmd is not None:
            out = self._spmd.run_window(self, key,
                                        [list(ins) for ins in inputs_batch])
        else:
            out = self._run_window(key, inputs_batch, bucket)
        self._mark_warm(key, bucket)
        return out

    def _run_window(self, key: SubgraphKey, inputs_batch: Sequence[Sequence],
                    bucket: int) -> List[List[torch.Tensor]]:
        """One stacked launch sequence of a window padded to ``bucket``
        with its first request; per-request outputs."""
        with span("band.stage"):
            args = stack_window(_pad(inputs_batch, bucket), self.device)
        return split_window(self._run(key, args), bucket, len(inputs_batch),
                            self._free[key])


def stack_window(padded: Sequence[Sequence],
                 device: torch.device) -> List[torch.Tensor]:
    """Each input position of a window stacked on its leading axis, on
    ``device``: one host-side stack and one copy where every request's
    value is on the host (a scalar input stacks as [B])."""
    args = []
    for pos in range(len(padded[0])):
        col = [ins[pos] for ins in padded]
        if all(isinstance(v, np.ndarray) for v in col):
            args.append(to_device(np.concatenate(
                [np.atleast_1d(v) for v in col], axis=0), device))
        else:
            args.append(torch.cat(
                [torch.atleast_1d(to_device(v, device)) for v in col], dim=0))
    return args


def _pad(inputs_batch: Sequence[Sequence], bucket: int) -> List[Sequence]:
    """The window filled to ``bucket`` with its first request (counted:
    ``rows_stacked``, ``rows_padded``)."""
    if not 1 <= len(inputs_batch) <= bucket:
        raise ExecutionError(
            f"a window of {len(inputs_batch)} requests in bucket {bucket}")
    counters.rows(bucket, bucket - len(inputs_batch))
    return list(inputs_batch) + [inputs_batch[0]] * (bucket - len(inputs_batch))


def split_window(outs: Sequence[torch.Tensor], bucket: int, n: int,
           free: Sequence[bool]) -> List[List[torch.Tensor]]:
    """The first ``n`` requests' outputs of a window stacked to ``bucket``;
    an output that carries no request axis (``free``) is every request's."""
    split = [[o] * bucket if f else torch.split(o, o.shape[0] // bucket,
                                                dim=0)
             for o, f in zip(outs, free)]
    return [[parts[b] for parts in split] for b in range(n)]


# ----------------------------------------------------------------------
# co-dispatch: the combined program of a model mix
# ----------------------------------------------------------------------
class ComboProgram:
    """Several (subgraph, bucket) windows, of any models on one worker,
    served as one dispatch.

    On a card, ``graph`` is one ``torch.cuda.CUDAGraph`` that captured
    every member's stacked launch sequence over the static input buffers
    ``static_inputs`` (per member, per input: ``[bucket * rows, ...]``)
    into ``static_outputs``; ``launch_tally`` holds the kernel calls one
    replay makes.  On the CPU ``graph`` is None and the members' programs
    run back to back."""

    def __init__(self, members, executors, device: torch.device):
        self.members: Tuple[Tuple[SubgraphKey, int], ...] = tuple(members)
        self.executors: List[ModelExecutor] = list(executors)
        self.device = device
        self.graph = None
        self.static_inputs: List[List[torch.Tensor]] = []
        self.static_outputs: List[List[torch.Tensor]] = []
        self.launch_tally: Dict[str, int] = {}


def build_combo(members: Sequence[Tuple[SubgraphKey, int]],
                executors: Sequence[ModelExecutor]) -> ComboProgram:
    """The combined program of ``members`` ((key, bucket) in canonical
    order, ``executors`` aligned with them).  Every member must be a
    prepared program without host ops that is ``capturable`` (a WHILE or
    an IF reads the host: refused by the flag, never by a failed
    capture), and all on one device.  On a card
    every member must have run eagerly at its bucket before: a capture
    may not build or load a kernel, and nothing in it may wait on the
    host."""
    if len(members) != len(executors) or not members:
        raise ExecutionError("a combo needs one executor per member")
    devices = {ex.device for ex in executors}
    if len(devices) != 1:
        raise ExecutionError(f"a combo's members span devices {devices}")
    for (key, bucket), ex in zip(members, executors):
        if ex.mesh is not None:
            raise ExecutionError(
                f"subgraph {key} runs on a mesh: its gathers and the "
                "control plane's announcements are not captured")
        if key not in ex._programs:
            raise ExecutionError(f"subgraph {key} not prepared")
        if ex._programs[key].has_custom:
            raise ExecutionError(f"subgraph {key} holds a host op")
        if not ex._programs[key].capturable:
            raise ExecutionError(
                f"subgraph {key} reads a value on the host (WHILE or IF): "
                "it cannot be captured into a combined program")
        if bucket < 1 or bucket & (bucket - 1):
            raise ExecutionError(f"bucket {bucket} is not a power of two")
    combo = ComboProgram(members, executors, devices.pop())
    if combo.device.type == "cuda":
        _capture(combo)
    return combo


def _capture(combo: ComboProgram) -> None:
    """Capture every member's stacked launch sequence into one CUDA graph.
    ``thread_local``: other workers' threads go on launching and waiting
    on events while this thread captures on its side stream."""
    from ..ops import kernels as K

    dev = combo.device
    with torch.cuda.device(dev):
        for (key, bucket), ex in zip(combo.members, combo.executors):
            combo.static_inputs.append([
                torch.zeros([bucket * max(shape[0], 1)]
                            + [max(s, 1) for s in shape[1:]],
                            dtype=torch_dtype(dtype), device=dev)
                for shape, dtype in ex._programs[key].input_specs])
        graph = torch.cuda.CUDAGraph()
        with K.recording() as tally, torch.inference_mode(), spans_off():
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = [ex._fns[key](ex._params[key], ins)
                        for (key, _), ex, ins in zip(
                            combo.members, combo.executors,
                            combo.static_inputs)]
    combo.static_outputs = [list(o) for o in outs]
    combo.launch_tally = dict(tally)
    combo.graph = graph


def _fill(static: torch.Tensor, col: Sequence, bucket: int) -> None:
    """Copy one input position of a padded window into its static buffer,
    after checking every request against the buffer's shape and type
    (the kernel wrappers' own checks do not run on a replay)."""
    rows = static.shape[0] // bucket
    want = (rows,) + tuple(static.shape[1:])
    for v in col:
        dt = v.dtype if isinstance(v, torch.Tensor) else torch_dtype(
            np.asarray(v).dtype)
        if tuple(v.shape) != want or dt != static.dtype:
            raise ExecutionError(
                f"combo input {tuple(v.shape)} {dt} does not fit its "
                f"static buffer: {want} {static.dtype}")
    if all(isinstance(v, np.ndarray) for v in col):
        host = torch.from_numpy(np.concatenate(col, axis=0)).pin_memory()
        static.copy_(host, non_blocking=True)
    else:
        torch.cat([to_device(v, static.device) for v in col], dim=0,
                  out=static)


def run_combo(combo: ComboProgram,
              inputs_groups: Sequence[Sequence[Sequence]]
              ) -> List[List[List[torch.Tensor]]]:
    """Serve one window per member (``inputs_groups`` aligned with
    ``combo.members``), each padded to its bucket with its first request;
    per-group, per-request outputs.  On a card, on the calling thread's
    current stream: the padded windows are copied into the static
    buffers, the graph replays, and the static outputs are cloned (the
    next replay overwrites them while a retire thread or a continuation
    may still read these); record the completion event after this
    returns.  On the CPU the members run back to back."""
    if len(inputs_groups) != len(combo.members):
        raise ExecutionError(
            f"{len(inputs_groups)} windows for a combo of "
            f"{len(combo.members)}")
    if combo.graph is None:
        return [ex._run_window(key, ins, bucket)
                for (key, bucket), ex, ins in zip(
                    combo.members, combo.executors, inputs_groups)]
    from ..ops import kernels as K

    with span("band.stage"):
        for (_, bucket), statics, ins_batch in zip(
                combo.members, combo.static_inputs, inputs_groups):
            padded = _pad(ins_batch, bucket)
            if len(padded[0]) != len(statics):
                raise ExecutionError(
                    f"{len(padded[0])} inputs for a member of {len(statics)}")
            for pos, static in enumerate(statics):
                _fill(static, [ins[pos] for ins in padded], bucket)
    combo.graph.replay()
    with torch.inference_mode():
        outs = [[o.clone() for o in group] for group in combo.static_outputs]
    K.add_launches(combo.launch_tally)
    return [split_window(group, bucket, len(ins), ex._free[key])
            for (key, bucket), ex, group, ins in zip(
                combo.members, combo.executors, outs, inputs_groups)]
