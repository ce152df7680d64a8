"""Meshes of devices and subgraph programs sharded over them.

The multi-device execution tier: a "mesh worker" runs a subgraph program
over a dp x tp grid of devices, weights split over "tp" and a window's
requests over "dp" (band_tpu/parallel/mesh.py, where GSPMD inserts the
collectives from the shardings; here they are explicit).

The program is column-parallel op by op.  An int8 CONV_2D,
DEPTHWISE_CONV_2D, FULLY_CONNECTED or TRANSPOSE_CONV whose output
channels divide by tp (ops/lowerings.py ``output_channels``) runs its own
lowering on each "tp" device of a row, with that column's slice of its
params (placed once, ``sharded_params_from_jax``) and, for a depthwise
conv, its own input channels; the slices are then gathered along the
channel axis before the next op: a concatenation onto the row's lead
device within a process, an ``all_gather`` over the row's process group
across processes.  Every other op runs whole on the row's lead device in
each process of the row.  A request's kernels thus run at 1/tp of the
width on every device, and each split op costs one gather.

Rows ("dp"): a window whose size divides by dp is split into dp equal
blocks of requests, one a row; its outputs are concatenated onto the
mesh's lead device (across processes each row's block is broadcast from
its first process, so every process holds the window's outputs, as
band_tpu's replicated outputs do).  Any other window runs whole: only on
as many rows as it takes for every process of the mesh to hold its
outputs.

Gathers and broadcasts are counted, with the host time spent in them
(``collective_stats``).

Counterpart: band_tpu/parallel/mesh.py (Mesh, make_mesh,
ShardedProgram, make_batched_fn, mesh_spans_processes).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend.executor import split_window, stack_window, to_device
from ..backend.program import (SubgraphProgram, params_from_jax,
                               sharded_params_from_jax, window_size)
from ..errors import ConfigError
from ..ops.lowerings import LowerCtx, output_channels, request_free
from ..ops.registry import get_lowering
from . import distributed as D


class Mesh:
    """A dp x tp grid of devices: ``devices[r, c]`` is a ``torch.device``
    of process ``processes[r, c]`` (as that process names it)."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: Sequence, dp: int, tp: int,
                 processes: Optional[Sequence[int]] = None):
        devices = [torch.device(d) for d in devices]
        if len(devices) != dp * tp:
            raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, got "
                             f"{len(devices)}")
        if processes is None:
            processes = [D.process_index()] * len(devices)
        self.devices = np.empty((dp, tp), dtype=object)
        for i, d in enumerate(devices):
            self.devices[i // tp, i % tp] = d
        self.processes = np.asarray(processes, np.int64).reshape(dp, tp)
        # process groups of a mesh spanning processes (attach_groups): the
        # mesh's own, and a row's where the row spans processes
        self.group = None
        self.row_groups: Dict[int, object] = {}
        self._attached = False

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.devices.shape[0], "tp": self.devices.shape[1]}

    def process_set(self) -> List[int]:
        return sorted({int(p) for p in self.processes.flat})

    def row_processes(self, r: int) -> List[int]:
        return sorted({int(p) for p in self.processes[r]})

    def local_cells(self, r: int, pidx: Optional[int] = None) -> List[int]:
        """The columns of row ``r`` on process ``pidx`` (default: this)."""
        pidx = D.process_index() if pidx is None else pidx
        return [c for c in range(self.devices.shape[1])
                if self.processes[r, c] == pidx]

    def lead(self, pidx: Optional[int] = None) -> Optional[torch.device]:
        """The first device of process ``pidx`` (default: this) in row
        order: where a mesh worker's inputs are staged and its outputs
        land on that process."""
        for r in range(self.devices.shape[0]):
            cells = self.local_cells(r, pidx)
            if cells:
                return self.devices[r, cells[0]]
        return None

    def attach_groups(self) -> None:
        """Create the process groups of a mesh that spans processes.
        COLLECTIVE: every process of the cluster builds the same meshes in
        the same order (the engines, worker by worker, from one config)."""
        if self._attached:
            return
        procs = self.process_set()
        if len(procs) > 1:
            if procs != list(range(D.process_count())):
                raise ConfigError(
                    f"a mesh spanning processes must hold a device of every "
                    f"process (has {procs} of {D.process_count()})")
            cards = self.devices[0, 0].type == "cuda"
            self.group = D.group(procs, cards)
            for r in range(self.devices.shape[0]):
                rp = self.row_processes(r)
                if len(rp) < 2:
                    continue
                counts = {len(self.local_cells(r, p)) for p in rp}
                if len(counts) != 1:
                    raise ConfigError(
                        f"mesh row {r} spans processes {rp} unevenly: each "
                        "must hold as many of its devices")
                self.row_groups[r] = (self.group if rp == procs
                                      else D.group(rp, cards))
        self._attached = True

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={self.devices.tolist()}, "
                f"processes={self.processes.tolist()})")


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when the mesh crosses processes (its outputs are then
    broadcast to every process, so that the leader holds them)."""
    return len(mesh.process_set()) > 1


def make_mesh(devices: Optional[Sequence] = None, dp: int = 1,
              tp: int = 1) -> Mesh:
    """A dp x tp mesh over the first dp*tp of this process's ``devices``
    (default: its cards, else its virtual CPU devices)."""
    if devices is None:
        devices = D.local_devices("cuda") or D.local_devices("cpu")
    devices = list(devices)
    if dp * tp > len(devices):
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have "
                         f"{len(devices)}")
    return Mesh(devices[: dp * tp], dp, tp)


# ----------------------------------------------------------------------
# collective accounting
# ----------------------------------------------------------------------
class _Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.counts = collections.Counter()
            self.seconds = collections.Counter()

    def add(self, kind: str, seconds: float) -> None:
        with self._lock:
            self.counts[kind] += 1
            self.seconds[kind] += seconds


_STATS = _Stats()


def collective_stats() -> Dict[str, float]:
    """This process's gathers (one per split op a row runs) and row
    broadcasts since the last reset, and the host seconds spent in each."""
    with _STATS._lock:
        return {"gathers": _STATS.counts["gather"],
                "gather_host_s": _STATS.seconds["gather"],
                "broadcasts": _STATS.counts["broadcast"],
                "broadcast_host_s": _STATS.seconds["broadcast"]}


def reset_collective_stats() -> None:
    _STATS.reset()


# ----------------------------------------------------------------------
# sharded programs
# ----------------------------------------------------------------------
class _RowParams(dict):
    """A row's params on this process: the whole ops' (name -> tensor on
    the row's lead device), and ``cells[c][op index]``: column c's shard
    of each split op, (tensors on the column's device, meta overrides)."""

    def __init__(self, whole, cells):
        super().__init__(whole)
        self.cells = cells


def _op_of(name: str) -> int:
    if name.startswith("op"):
        return int(name[2:name.index("/")])
    return -1


class ShardedProgram:
    """A subgraph program over a mesh: weights split on "tp" once, at
    construction (``params``: this process's rows; ``place=False`` places
    none), windows split on "dp" where their size divides.  ``run(params,
    inputs)`` takes the inputs of a window stacked on their leading axis,
    as the single-device program does (the window's size is read from
    them), and returns its outputs on the mesh's lead device of this
    process (``lead``).  ``params`` may hold band_tpu's prepared params
    (numpy) in place of ``prog``'s own."""

    def __init__(self, prog: SubgraphProgram, mesh: Mesh, params=None,
                 place: bool = True):
        self.prog = prog
        self.mesh = mesh
        self.me = D.process_index()
        mesh.attach_groups()
        dp, tp = mesh.shape["dp"], mesh.shape["tp"]
        graph = prog.graph
        params = prog.params if params is None else params
        host = {k: np.asarray(v) for k, v in params.items()}
        # the ops split by output channel: op index -> (channels, multiplier)
        self.shards: Dict[int, Tuple[int, int]] = {}
        if tp > 1:
            for oi in prog.op_indices:
                oc = output_channels(graph, graph.ops[oi])
                if oc and oc[0] % tp == 0 and (oc[0] // tp) % oc[1] == 0:
                    self.shards[oi] = oc
        self.rows = [r for r in range(dp) if mesh.local_cells(r, self.me)]
        if not self.rows:
            raise ConfigError(f"process {self.me} holds no device of {mesh}")
        self.leads = {r: mesh.devices[r, mesh.local_cells(r, self.me)[0]]
                      for r in self.rows}
        self.lead = self.leads[self.rows[0]]
        # the rows an unsplit window runs on: each process of the mesh in
        # one of them, every process of each
        covered: set = set()
        self.cover = []
        for r in range(dp):
            rp = set(mesh.row_processes(r))
            if not rp <= covered:
                self.cover.append(r)
                covered |= rp
        # per spanning row: where each column lands among the gathered
        # blocks (ranks in order, each rank's columns in order)
        self._col_order: Dict[int, Optional[List[int]]] = {}
        for r in mesh.row_groups:
            flat = [c for p in mesh.row_processes(r)
                    for c in mesh.local_cells(r, p)]
            self._col_order[r] = (None if flat == list(range(tp))
                                  else [flat.index(c) for c in range(tp)])
        free = request_free(graph)
        self._free_in = tuple(t in free for t in prog.input_ids)
        self._free_out = prog.output_free
        self._fns = {r: prog.make_fn(
            run_op=lambda ctx, op, r=r: self._split_op(r, ctx, op))
            for r in self.rows}
        self.params: Dict[int, _RowParams] = {}
        if place:
            whole = {k: v for k, v in host.items()
                     if _op_of(k) not in self.shards}
            for r in self.rows:
                cells = {}
                for c in mesh.local_cells(r, self.me):
                    dev = mesh.devices[r, c]
                    cells[c] = {
                        oi: sharded_params_from_jax(
                            graph, host, prog.meta, oi, c * oc // tp,
                            (c + 1) * oc // tp, dev)
                        for oi, (oc, _) in self.shards.items()}
                self.params[r] = _RowParams(
                    params_from_jax(whole, self.leads[r]), cells)

    # ------------------------------------------------------------------
    def __call__(self, inputs: Sequence) -> List[torch.Tensor]:
        return self.run(self.params, inputs)

    def run(self, params: Dict[int, _RowParams], inputs: Sequence,
            local_rows: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """The outputs of a window whose inputs are stacked on their leading
        axis.  ``local_rows``: the inputs hold only these consecutive dp
        rows' blocks of a split window (a process's own rows, placed by
        the control plane, parallel/spmd.py)."""
        prog, mesh = self.prog, self.mesh
        dp = mesh.shape["dp"]
        held = len(local_rows) if local_rows is not None else dp
        first = local_rows[0] if local_rows is not None else 0
        batch = window_size(prog.graph, prog.input_ids, inputs) * dp // held
        split = dp > 1 and batch % dp == 0
        rows = self.rows if split else [r for r in self.cover
                                        if r in self.leads]
        outs: Dict[int, List[torch.Tensor]] = {}
        for r in rows:
            row_in = []
            for x, free in zip(inputs, self._free_in):
                if split and not free:
                    n = x.shape[0] // held
                    x = x[(r - first) * n:(r - first + 1) * n]
                row_in.append(to_device(x, self.leads[r]))
            with torch.inference_mode():
                outs[r] = self._fns[r](params[r], row_in)
        if not split:
            return [o.to(self.lead) for o in outs[rows[0]]]
        return self._join_rows(outs)

    def _join_rows(self, outs: Dict[int, List[torch.Tensor]]
                   ) -> List[torch.Tensor]:
        """A split window's outputs, every row's block in row order, on
        the lead device; across processes each row's block is broadcast
        from the first process of its row."""
        mesh = self.mesh
        spans = mesh.group is not None
        mine = outs[self.rows[0]]
        result = []
        for k, free in enumerate(self._free_out):
            if free:  # one value for every request: any row's
                result.append(mine[k].to(self.lead))
                continue
            parts = []
            for r in range(mesh.shape["dp"]):
                t = outs[r][k].to(self.lead) if r in outs else None
                if spans:
                    t0 = time.perf_counter()
                    if t is None:
                        t = torch.empty_like(mine[k], device=self.lead)
                    t = D.broadcast(t, mesh.row_processes(r)[0], mesh.group)
                    _STATS.add("broadcast", time.perf_counter() - t0)
                parts.append(t)
            result.append(torch.cat(parts, dim=0))
        return result

    def _split_op(self, r: int, ctx: LowerCtx, op) -> bool:
        """Run ``op`` split by output channel across row ``r``'s columns
        on this process, then gather the slices (True), or leave it to
        its lowering (False)."""
        split = self.shards.get(op.index)
        if split is None:
            return False
        oc, mult = split
        width = oc // self.mesh.shape["tp"]
        cells = ctx.params.cells
        parts = []
        for c in self.mesh.local_cells(r, self.me):
            dev = self.mesh.devices[r, c]
            own, over = cells[c][op.index]
            sctx = LowerCtx(ctx.graph, own,
                            collections.ChainMap(over, ctx.meta),
                            batch=ctx.batch, free=ctx.free)
            for pos, tid in enumerate(op.inputs):
                if tid < 0 or tid not in ctx.env:
                    continue
                v = ctx.env[tid]
                if op.opname == "DEPTHWISE_CONV_2D" and pos == 0:
                    # channel c * m + j reads input channel c
                    v = v[..., c * width // mult:(c + 1) * width // mult]
                sctx.set(tid, v.to(dev).contiguous())
            get_lowering(op.opname).trace(sctx, op)
            parts.append(sctx.arr(op.outputs[0]))
        ctx.set(op.outputs[0], self._gather(r, parts))
        return True

    def _gather(self, r: int, parts: List[torch.Tensor]) -> torch.Tensor:
        """Row ``r``'s output-channel slices as one tensor on its lead
        device: this process's concatenated, then, where the row spans
        processes, every process's through the row's group."""
        t0 = time.perf_counter()
        lead = self.leads[r]
        out = torch.cat([p.to(lead) for p in parts], dim=-1) \
            if len(parts) > 1 else parts[0].to(lead)
        g = self.mesh.row_groups.get(r)
        if g is not None:
            blocks = D.all_gather(out, g)
            order = self._col_order[r]
            if order is None:
                out = torch.cat(blocks, dim=-1)
            else:
                k = len(parts)
                pieces = [p for b in blocks for p in b.chunk(k, dim=-1)]
                out = torch.cat([pieces[i] for i in order], dim=-1)
        _STATS.add("gather", time.perf_counter() - t0)
        return out


def make_batched_fn(prog: SubgraphProgram, mesh: Mesh, batch: int):
    """A function for a continuous-batching window of ``batch`` requests
    on a mesh worker: ``fn(params, inputs_batch)`` stacks the B
    per-request input tuples, splits the stack on "dp" where B divides,
    runs the program with the weights split on "tp", and returns the
    outputs per request.  ``params`` is the placement of the worker's
    ShardedProgram (``.params``), so every window size shares one copy of
    the weights."""
    runner = ShardedProgram(prog, mesh, place=False)

    def fn(params, inputs_batch):
        if len(inputs_batch) != batch:
            raise ValueError(f"a window of {len(inputs_batch)} for {batch}")
        outs = runner.run(params, stack_window(inputs_batch, runner.lead))
        return tuple(tuple(o) for o in split_window(
            outs, batch, batch, runner._free_out))

    return fn
