"""One engine spanning processes: the SPMD serving control plane.

The reference is strictly single-process (SURVEY §5.8); the multi-host
obligation (SURVEY §2.9 "Distributed comm backend") is served here by
running ONE logical engine over a ``torch.distributed`` cluster
(parallel/distributed.py), as band_tpu/parallel/spmd.py does over
``jax.distributed``:

 * **Leader** (process 0) runs the full engine: planner, schedulers,
   workers, request front-ends.  Mesh workers whose devices span
   processes run sharded programs (parallel/mesh.py) whose gathers
   involve every process.
 * **Followers** (process > 0) build the *same* engine (same config,
   same models registered in the same order: registration itself is
   collective, because online profiling runs the shared sharded
   programs in lockstep) and then replay the leader's cross-process
   launches, so that every process issues a mesh's collectives in the
   same order.

 * **Host-side TCP control plane.**  Announcements ride ordinary
   sockets (leader listens, followers connect), not collectives: cheap,
   FIFO per connection, no global ordering.  Only the program launches
   run collectives, and each mesh has its own process groups, so they
   need a consistent order only per mesh.
 * **Per-worker pipelining.**  Each spanning mesh worker has its own
   announce lock on the leader and its own replay thread on every
   follower; two mesh workers' dispatches do not serialize each other.
 * **Input placement.**  Every process stages only its own dp rows of a
   split window (``ENC_ROWS``: the leader sends each follower its rows)
   and runs its own shards; the gathers the program needs run as
   collectives over the process groups, not as payload replication
   through the control channel.
 * **Payload caching.**  Repeated input objects (staged serving tensors)
   are shipped once per worker channel, then referenced by id: steady-
   state announcements carry ~100 bytes of metadata.  Caches are bounded
   LRU, scoped per worker channel so the follower mirror stays
   deterministic (all cache operations for a worker ride that worker's
   FIFO).
 * **Failure detection.**  A monitor thread per follower socket turns a
   dead follower into quarantined mesh workers and failed jobs instead of
   a wedged collective (which the groups' timeout bounds anyway); a
   crashed replay on the follower closes the socket so the leader
   notices.
 * **Hot (un)registration.**  ``SpmdChannel.register_model`` drains the
   per-worker channels, replicates the registration on every process in
   lockstep (profiling is collective), and rebuilds the slot table.

Single-process meshes never touch this module; the hook in
``ModelExecutor`` engages only for meshes that span processes.

Counterpart: band_tpu/parallel/spmd.py, whose framing, caches, channel,
monitor and quarantine this module keeps; its ``_StackedLauncher``
(jitted programs over ``make_array_from_process_local_data``) becomes
each process staging its own rows and running its shards, and its jax
barrier a process-group barrier.
"""

from __future__ import annotations

import json
import queue as queue_mod
import socket
import struct
import threading
import time
import traceback
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend.executor import split_window
from ..errors import ExecutionError
from ..tracing.logger import log_error
from . import distributed as D
from .mesh import mesh_spans_processes

OP_HELLO = 0
OP_SHUTDOWN = 1
OP_EXEC = 2          # worker frame: launch a stacked window
OP_REGISTER = 3      # global frame: replicate a model registration
OP_UNREGISTER = 4    # global frame: replicate an unregistration
OP_SYNC = 5          # internal sentinel for worker-queue drains

# per-position input encodings inside an OP_EXEC frame
ENC_REF = 0    # 1 blob: int64 cache ids [bucket] (all rows cached)
ENC_STAGE = 1  # 2 blobs: int64 ids [bucket] (-1 = don't cache) + full stack
ENC_ROWS = 2   # 1 blob: the receiving process's dp rows of the stack
ENC_FULL = 3   # 1 blob: the full stacked array (replicated input)

_HDR = struct.Struct("!BiiiI")  # op, a, b, c, n_blobs
_BLOB_HDR = struct.Struct("!16sBq")  # dtype name, ndim, payload bytes
_CACHE_CAPACITY = 256  # per worker channel


def spans_processes(ex) -> bool:
    mesh = getattr(ex, "mesh", None)
    return mesh is not None and mesh_spans_processes(mesh)


def _key_sort(key) -> Tuple:
    return (key.model_id, key.worker_id, tuple(sorted(key.unit_indices)))


def control_address(
    coordinator_address: str, control_port: int = 0
) -> Tuple[str, int]:
    """The control plane's TCP endpoint, derived from the coordinator
    address (its port + 1000) unless explicitly configured."""
    host, _, port = coordinator_address.rpartition(":")
    if control_port > 0:
        return host or "localhost", control_port
    return host or "localhost", int(port) + 1000


# ----------------------------------------------------------------------
# framing
# ----------------------------------------------------------------------
def _send_frame(sock, op: int, a: int, b: int, c: int,
                blobs: Sequence[np.ndarray]) -> None:
    parts = [_HDR.pack(op, a, b, c, len(blobs))]
    for arr in blobs:
        arr = np.ascontiguousarray(arr)
        payload = arr.tobytes()
        dt = str(arr.dtype).encode()[:16].ljust(16, b"\0")
        parts.append(_BLOB_HDR.pack(dt, arr.ndim, len(payload)))
        parts.append(struct.pack(f"!{arr.ndim}q", *arr.shape))
        parts.append(payload)
    sock.sendall(b"".join(parts))


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("spmd control channel closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock):
    op, a, b, c, n_blobs = _HDR.unpack(_recv_exact(sock, _HDR.size))
    blobs = []
    for _ in range(n_blobs):
        dt, ndim, nbytes = _BLOB_HDR.unpack(
            _recv_exact(sock, _BLOB_HDR.size)
        )
        shape = struct.unpack(f"!{ndim}q", _recv_exact(sock, 8 * ndim))
        data = _recv_exact(sock, nbytes)
        blobs.append(
            np.frombuffer(data, dtype=np.dtype(dt.rstrip(b"\0").decode()))
            .reshape(shape)
        )
    return op, a, b, c, blobs


# ----------------------------------------------------------------------
# per-worker payload caches
# ----------------------------------------------------------------------
class _LeaderCache:
    """object -> (id, host copy), bounded LRU.  Strong references while
    cached guarantee id() stability (a live object's id can't recycle);
    eviction order is mirrored on the follower because every insert and
    touch for one worker rides that worker's FIFO channel."""

    def __init__(self, capacity: int = _CACHE_CAPACITY):
        self.capacity = capacity
        self._by_obj: "OrderedDict[int, Tuple[object, int, np.ndarray]]" = (
            OrderedDict()
        )
        self._next_id = 0

    def lookup(self, obj) -> Optional[Tuple[int, np.ndarray]]:
        ent = self._by_obj.get(id(obj))
        if ent is None or ent[0] is not obj:
            return None
        self._by_obj.move_to_end(id(obj))
        return ent[1], ent[2]

    def insert(self, obj, host: np.ndarray) -> int:
        cid = self._next_id
        self._next_id += 1
        self._by_obj[id(obj)] = (obj, cid, host)
        self._by_obj.move_to_end(id(obj))
        while len(self._by_obj) > self.capacity:
            self._by_obj.popitem(last=False)
        return cid


class _FollowerCache:
    """id -> host array with the same LRU policy as the leader side.
    Touched only from one worker's replay thread: no locking."""

    def __init__(self, capacity: int = _CACHE_CAPACITY):
        self.capacity = capacity
        self._store: "OrderedDict[int, np.ndarray]" = OrderedDict()

    def insert(self, cid: int, host: np.ndarray) -> None:
        self._store[cid] = host
        self._store.move_to_end(cid)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    def get(self, cid: int) -> np.ndarray:
        host = self._store[cid]
        self._store.move_to_end(cid)
        return host


# ----------------------------------------------------------------------
# stacked window execution (shared by leader and followers)
# ----------------------------------------------------------------------
def _contiguous(rows: List[int]) -> bool:
    return bool(rows) and rows == list(range(rows[0], rows[-1] + 1))


class _StackedLauncher:
    """Per-(executor, key, bucket) placement of a window: which of the
    window's requests each process stages.  A window whose bucket
    divides by dp is split when every process's requests (those of its
    dp rows) form one contiguous block; each process then stages only
    its block, else the whole window."""

    def __init__(self, ex, key, bucket: int):
        self.ex = ex
        self.key = key
        self.bucket = bucket
        mesh = ex.mesh
        dp = mesh.shape["dp"]
        self.dp_sharded = False
        self.rows_by_pidx: Dict[int, List[int]] = {}
        self.dp_rows_by_pidx: Dict[int, List[int]] = {}
        if dp > 1 and bucket % dp == 0:
            per = bucket // dp
            dp_rows = {p: [r for r in range(dp) if mesh.local_cells(r, p)]
                       for p in mesh.process_set()}
            rows = {p: [i for r in rs for i in range(r * per, (r + 1) * per)]
                    for p, rs in dp_rows.items()}
            if all(_contiguous(r) for r in rows.values()) and all(
                    _contiguous(r) for r in dp_rows.values()):
                self.dp_sharded = True
                self.rows_by_pidx = rows
                self.dp_rows_by_pidx = dp_rows

    def my_rows(self) -> Optional[List[int]]:
        """This process's contiguous block of requests, or None when the
        window is not split (every process stages all of it)."""
        return self.rows_of(D.process_index())

    def rows_of(self, pidx: int) -> Optional[List[int]]:
        if not self.dp_sharded:
            return None
        return self.rows_by_pidx.get(pidx, [])

    def launch(self, local_stacks: List[np.ndarray]) -> List[torch.Tensor]:
        """local_stacks[pos] = this process's requests of the window
        ([requests, *model shape]; the whole window where it is not
        split).  Returns the window's outputs, stacked, on the mesh's
        lead device of this process: every request's on every process."""
        args = []
        for stack in local_stacks:
            stack = np.ascontiguousarray(stack)
            if stack.ndim >= 2:  # requests' [d0, ...] blocks, stacked
                stack = stack.reshape((-1,) + stack.shape[2:])
            args.append(torch.from_numpy(stack))
        local_rows = (self.dp_rows_by_pidx[D.process_index()]
                      if self.dp_sharded else None)
        return self.ex._fns[self.key](self.ex._params[self.key], args,
                                      local_rows)


def _get_launcher(ex, key, bucket: int) -> _StackedLauncher:
    cache = getattr(ex, "_spmd_launchers", None)
    if cache is None:
        cache = ex._spmd_launchers = {}
    launcher = cache.get((key, bucket))
    if launcher is None:
        launcher = cache[(key, bucket)] = _StackedLauncher(ex, key, bucket)
    return launcher


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# ----------------------------------------------------------------------
# the channel
# ----------------------------------------------------------------------
class SpmdChannel:
    """Cross-process dispatch replication for one engine.

    Build on every process AFTER the initial models are registered (the
    slot table must be identical everywhere).  On the leader call
    ``attach()`` then serve; on followers call ``run_follower()``.
    Models can be (un)registered afterwards through
    ``register_model``/``unregister_model``."""

    def __init__(self, engine, coordinator_address: str = "",
                 control_port: int = 0, connect_timeout: float = 120.0):
        self.engine = engine
        self.is_leader = D.process_index() == 0
        self._failed = False
        self._fail_reason = ""
        self._worker_locks: Dict[int, threading.Lock] = {}
        self._register_lock = threading.Lock()
        self._slots: Dict = {}
        self._by_slot: List[Tuple[object, object]] = []
        self._caches: Dict[int, _LeaderCache] = {}
        self._fcaches: Dict[int, _FollowerCache] = {}
        self._socks: List[socket.socket] = []          # leader: followers
        self._sock_locks: List[threading.Lock] = []
        self._sock: Optional[socket.socket] = None     # follower: leader
        self._monitors: List[threading.Thread] = []
        self._rebuild_slots()
        if D.process_count() > 1:
            host, port = control_address(
                coordinator_address or "localhost:0", control_port
            )
            if self.is_leader:
                self._listen(port, D.process_count() - 1, connect_timeout)
            else:
                self._connect(host, port, connect_timeout)

    # -- bootstrap -----------------------------------------------------
    def _listen(self, port: int, n_followers: int, timeout: float) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", port))
        srv.listen(n_followers)
        srv.settimeout(timeout)
        conns: Dict[int, socket.socket] = {}
        try:
            for _ in range(n_followers):
                conn, _addr = srv.accept()
                conn.settimeout(None)  # accepted conns must block forever
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                op, pid, _, _, _ = _recv_frame(conn)
                if op != OP_HELLO:
                    raise ConnectionError(f"expected HELLO, got op {op}")
                conns[pid] = conn
        finally:
            srv.close()
        # follower i in self._socks is process_index i+1
        for pid in sorted(conns):
            self._socks.append(conns[pid])
            self._sock_locks.append(threading.Lock())

    def _connect(self, host: str, port: int, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection((host, port), timeout=5.0)
                # the connect timeout must NOT persist as the recv
                # timeout: serving gaps are unbounded (registration, idle)
                s.settimeout(None)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                _send_frame(s, OP_HELLO, D.process_index(), 0, 0, [])
                self._sock = s
                return
            except OSError as e:  # leader not listening yet
                last = e
                time.sleep(0.1)
        raise ConnectionError(f"spmd control connect failed: {last}")

    # -- slot table ----------------------------------------------------
    def _rebuild_slots(self) -> None:
        self._slots = {}
        self._by_slot = []
        for mid in sorted(self.engine.list_models()):
            rec = self.engine.model_record(mid)
            for wid in sorted(rec.executors):
                ex = rec.executors[wid]
                if not spans_processes(ex):
                    continue
                for key in sorted(ex._programs, key=_key_sort):
                    self._slots[key] = len(self._by_slot)
                    self._by_slot.append((ex, key))
                self._worker_locks.setdefault(wid, threading.Lock())

    def barrier(self) -> None:
        """Every process reaches this point (a process-group barrier)."""
        D.barrier()

    def attach(self) -> None:
        """Leader: hook every cross-process executor so its launches
        run through the channel, and start follower-failure monitors."""
        assert self.is_leader, "attach() is leader-only"
        for ex, _ in self._by_slot:
            ex._spmd = self
        for i, s in enumerate(self._socks):
            t = threading.Thread(
                target=self._monitor, args=(i, s),
                name=f"band-spmd-monitor-{i}", daemon=True,
            )
            t.start()
            self._monitors.append(t)

    # -- failure handling ----------------------------------------------
    def _monitor(self, idx: int, s: socket.socket) -> None:
        # followers send nothing after HELLO; recv returning b"" (or
        # raising) means the follower died or closed on a replay error
        try:
            while True:
                data = s.recv(4096)
                if not data:
                    raise ConnectionError("follower closed the channel")
        except Exception as e:
            if not self._failed:
                self._on_follower_lost(idx, e)

    def _on_follower_lost(self, idx: int, err: Exception) -> None:
        self._failed = True
        self._fail_reason = f"follower {idx + 1}: {err}"
        log_error(
            "spmd follower lost (%s); quarantining process-spanning mesh "
            "workers: in-flight jobs fail, queued work reschedules onto "
            "surviving workers", self._fail_reason,
        )
        wids = sorted({key.worker_id for _, key in self._by_slot})
        for wid in wids:
            try:
                w = self.engine.workers[wid]
                if w._quarantined:
                    continue
                # recover=False: a mesh spanning a DEAD process cannot
                # come back: the process group's membership is fixed at
                # bring-up, and a recovery probe would launch a collective
                # that waits on the dead participant until its timeout.
                requeue = w.quarantine(recover=False)
                if requeue:
                    self.engine.enqueue_batch(requeue, push_front=True)
            except Exception:
                log_error("quarantine of worker %d failed:\n%s", wid,
                          traceback.format_exc())
        try:
            self.engine.trigger()
        except Exception:
            pass

    def check_ok(self) -> None:
        if self._failed:
            raise ExecutionError(
                f"spmd control plane failed: {self._fail_reason}"
            )

    # -- leader dispatch -----------------------------------------------
    def run_window(self, ex, key, inputs_batch) -> List[List[torch.Tensor]]:
        """Execute a continuous-batching window (B >= 1 requests) of a
        process-spanning subgraph: announce it to the followers over the
        per-worker channel, stage this process's rows, run the shards.
        Returns per-request output lists."""
        self.check_ok()
        B = len(inputs_batch)
        bucket = 1 if B == 1 else 1 << (B - 1).bit_length()
        padded = list(inputs_batch) + [inputs_batch[0]] * (bucket - B)
        n_pos = len(padded[0])
        launcher = _get_launcher(ex, key, bucket)
        slot = self._slots[key]
        wid = key.worker_id
        lock = self._worker_locks.setdefault(wid, threading.Lock())
        cache = self._caches.setdefault(wid, _LeaderCache())
        with lock:
            encs: List[int] = []
            pos_refs: List[Optional[np.ndarray]] = []
            pos_stack: List[np.ndarray] = []
            for p in range(n_pos):
                refs: List[int] = []
                hosts: List[np.ndarray] = []
                fresh = False
                for v in (ins[p] for ins in padded):
                    hit = cache.lookup(v)
                    if hit is not None:
                        refs.append(hit[0])
                        hosts.append(hit[1])
                        continue
                    h = _host(v)
                    hosts.append(h)
                    fresh = True
                    # a staged serving tensor: ship once, then by ref
                    refs.append(cache.insert(v, h)
                                if isinstance(v, torch.Tensor) else -1)
                pos_stack.append(np.stack(hosts))
                if not fresh:
                    encs.append(ENC_REF)
                    pos_refs.append(np.asarray(refs, np.int64))
                elif any(r >= 0 for r in refs):
                    encs.append(ENC_STAGE)
                    pos_refs.append(np.asarray(refs, np.int64))
                else:
                    encs.append(ENC_ROWS if launcher.dp_sharded else ENC_FULL)
                    pos_refs.append(None)
            # announce to every follower
            enc_blob = np.asarray(encs, np.int64)
            for i, (s, slock) in enumerate(
                zip(self._socks, self._sock_locks)
            ):
                if self._failed:
                    break
                blobs: List[np.ndarray] = [enc_blob]
                for p, enc in enumerate(encs):
                    if enc in (ENC_REF, ENC_STAGE):
                        blobs.append(pos_refs[p])
                    if enc == ENC_ROWS:
                        r = launcher.rows_of(i + 1)
                        blobs.append(pos_stack[p][r[0]: r[-1] + 1]
                                     if r else pos_stack[p][:0])
                    elif enc != ENC_REF:
                        blobs.append(pos_stack[p])
                try:
                    with slock:
                        _send_frame(s, OP_EXEC, wid, slot, bucket, blobs)
                except OSError as e:
                    self._on_follower_lost(i, e)
            self.check_ok()
            # local placement + launch
            my_rows = launcher.my_rows()
            local_stacks = [
                st if my_rows is None else st[my_rows[0]: my_rows[-1] + 1]
                for st in pos_stack
            ]
            outs = launcher.launch(local_stacks)
        return split_window(outs, bucket, B, ex._free[key])

    # -- model lifecycle across processes ------------------------------
    def _hold_workers(self) -> List[threading.Lock]:
        held = [self._worker_locks[w] for w in sorted(self._worker_locks)]
        for lk in held:
            lk.acquire()
        return held

    def _announce(self, op: int, a: int, blobs) -> None:
        for i, (s, slock) in enumerate(zip(self._socks, self._sock_locks)):
            try:
                with slock:
                    _send_frame(s, op, a, 0, 0, blobs)
            except OSError as e:
                self._on_follower_lost(i, e)

    def register_model(self, path: str, target_worker: int = -1,
                       numerics: Optional[str] = None) -> int:
        """Leader: replicate a model registration on every process
        (registration is collective: online profiling of spanning
        subgraphs runs their gathers) and rebuild slot tables.  ``path``
        must be readable on every host (shared FS)."""
        assert self.is_leader
        self.check_ok()
        from ..ir.model import Model

        with self._register_lock:
            # hold every worker lock: no announces interleave with the
            # collective registration; followers drain their queues
            # before registering (FIFO on the socket)
            held = self._hold_workers()
            try:
                meta = json.dumps({"path": path,
                                   "target_worker": target_worker,
                                   "numerics": numerics}).encode()
                self._announce(OP_REGISTER, 0,
                               [np.frombuffer(meta, np.uint8)])
                self.check_ok()
                mid = self.engine.register_model(
                    Model.from_path(path), target_worker=target_worker,
                    numerics=numerics,
                )
                self._rebuild_slots()
                for ex, _ in self._by_slot:
                    ex._spmd = self
                return mid
            finally:
                for lk in held:
                    lk.release()

    def unregister_model(self, model_id: int) -> None:
        assert self.is_leader
        self.check_ok()
        with self._register_lock:
            held = self._hold_workers()
            try:
                self._announce(OP_UNREGISTER, model_id, [])
                self.engine.unregister_model(model_id)
                self._rebuild_slots()
            finally:
                for lk in held:
                    lk.release()

    def shutdown_followers(self) -> None:
        """Leader: release followers from their replay loops."""
        if not self.is_leader:
            return
        for s, slock in zip(self._socks, self._sock_locks):
            try:
                with slock:
                    _send_frame(s, OP_SHUTDOWN, 0, 0, 0, [])
            except OSError:
                pass

    # -- follower side -------------------------------------------------
    def run_follower(self) -> None:
        """Demux loop: route worker frames to per-worker replay threads
        (pipelining across workers), handle global frames (register/
        unregister/shutdown) after draining the worker queues.  Returns
        on the leader's shutdown frame; closes the socket on a replay
        error so the leader's monitor can quarantine."""
        assert not self.is_leader, "run_follower() is follower-only"
        queues: Dict[int, queue_mod.Queue] = {}
        threads: Dict[int, threading.Thread] = {}
        errors: List[BaseException] = []

        def _replay_loop(wid: int, q: queue_mod.Queue) -> None:
            while True:
                item = q.get()
                if item is None:
                    return
                if item[0] == OP_SYNC:
                    item[1].set()
                    continue
                _, slot, bucket, blobs = item
                try:
                    self._replay_exec(wid, slot, bucket, blobs)
                except Exception as e:
                    errors.append(e)
                    log_error(
                        "spmd follower replay failed (worker %d):\n%s",
                        wid, traceback.format_exc(),
                    )
                    try:  # surface to the leader: EOF -> quarantine
                        self._sock.close()
                    except OSError:
                        pass
                    return

        def _q(wid: int) -> queue_mod.Queue:
            if wid not in queues:
                queues[wid] = queue_mod.Queue()
                t = threading.Thread(
                    target=_replay_loop, args=(wid, queues[wid]),
                    name=f"band-spmd-replay-{wid}", daemon=True,
                )
                t.start()
                threads[wid] = t
            return queues[wid]

        def _drain() -> None:
            evs = []
            for q in queues.values():
                ev = threading.Event()
                q.put((OP_SYNC, ev))
                evs.append(ev)
            for ev in evs:
                ev.wait(timeout=600)

        try:
            while True:
                if errors:
                    raise errors[0]
                op, a, b, c, blobs = _recv_frame(self._sock)
                if op == OP_SHUTDOWN:
                    return
                if op == OP_EXEC:
                    _q(a).put((OP_EXEC, b, c, blobs))
                elif op == OP_REGISTER:
                    from ..ir.model import Model

                    _drain()
                    meta = json.loads(bytes(blobs[0].tobytes()).decode())
                    self.engine.register_model(
                        Model.from_path(meta["path"]),
                        target_worker=meta["target_worker"],
                        numerics=meta.get("numerics"),
                    )
                    self._rebuild_slots()
                elif op == OP_UNREGISTER:
                    _drain()
                    self.engine.unregister_model(a)
                    self._rebuild_slots()
        finally:
            for q in queues.values():
                q.put(None)
            for t in threads.values():
                t.join(timeout=10)

    def _replay_exec(self, wid: int, slot: int, bucket: int, blobs) -> None:
        ex, key = self._by_slot[slot]
        launcher = _get_launcher(ex, key, bucket)
        fcache = self._fcaches.setdefault(wid, _FollowerCache())
        encs = [int(v) for v in blobs[0]]
        my_rows = launcher.my_rows()
        mine = (slice(my_rows[0], my_rows[-1] + 1) if my_rows is not None
                else slice(0, bucket))
        cursor = 1
        local_stacks = []
        for enc in encs:
            if enc == ENC_REF:
                refs = blobs[cursor]
                cursor += 1
                stack = np.stack([fcache.get(int(r)) for r in refs[mine]])
            elif enc == ENC_STAGE:
                refs, full = blobs[cursor], blobs[cursor + 1]
                cursor += 2
                for b in range(bucket):
                    if int(refs[b]) >= 0:
                        fcache.insert(int(refs[b]), np.asarray(full[b]))
                stack = full[mine]
            elif enc == ENC_ROWS:
                stack = blobs[cursor]  # already this process's rows
                cursor += 1
            else:  # ENC_FULL
                stack = blobs[cursor][mine]
                cursor += 1
            local_stacks.append(stack)
        launcher.launch(local_stacks)
        if ex.device.type == "cuda":
            torch.cuda.synchronize(ex.device)
