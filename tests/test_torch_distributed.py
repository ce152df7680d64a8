"""The port's multi-process tier in one process: copies of
tests/test_distributed.py (the distributed config, the process-major
global mesh, ICI against DCN transfer costing) and of
tests/test_spmd_channel.py (the SPMD control plane's framing, payload
caches, the metadata-only steady state of run_window, follower loss,
per-worker pipelining), with an instrumented pseudo-follower socket.
The two-process cluster is tests/test_torch_multiprocess.py."""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import band_tpu_torch as tb
from band_tpu.config import config_from_dict as jconfig
from band_tpu_torch.config import DistributedConfig, config_from_dict
from band_tpu_torch.parallel import distributed as D
from band_tpu_torch.parallel import spmd
from band_tpu_torch.runtime.link_costs import DCN, DEFAULTS, ICI
from tests.gen_torch_goldens import GOLDENS_PATH, golden_inputs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FC = os.path.join(DATA, "fc_int8.tflite")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and torch's thread pool on busy cores is far slower
    than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# tests/test_distributed.py
# ----------------------------------------------------------------------
def test_distributed_config_from_json():
    d = {
        "schedulers": ["fixed_worker"],
        "workers": [{"device": "cpu", "device_ids": [0]}],
        "distributed": {
            "coordinator_address": "10.0.0.1:8476",
            "num_processes": 4,
            "process_id": 2,
            "local_device_ids": [0, 1],
        },
    }
    cfg, ref = config_from_dict(d).distributed, jconfig(d).distributed
    assert cfg.enabled
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            cfg.local_device_ids) == ("10.0.0.1:8476", 4, 2, (0, 1))
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            cfg.local_device_ids) == (
        ref.coordinator_address, ref.num_processes, ref.process_id,
        ref.local_device_ids)
    assert not DistributedConfig().enabled


def test_global_mesh_auto_sizes_and_orders_host_major():
    devices = D.devices("cpu")
    assert len(devices) == D.CPU_VIRTUAL_DEVICES
    mesh = D.global_mesh(devices=devices)
    # single process: tp = all local devices, dp = 1
    assert mesh.shape == {"dp": 1, "tp": 8}
    mesh = D.global_mesh(dp=4, tp=2, devices=devices)
    assert mesh.shape == {"dp": 4, "tp": 2}
    assert D.process_span(devices) == 1
    with pytest.raises(ValueError):
        D.global_mesh(dp=8, tp=2, devices=devices)
    # two processes of two devices each, listed interleaved: rows are
    # one process's devices (process-major)
    two = [D.GlobalDevice(p, torch.device("cpu")) for p in (1, 0, 1, 0)]
    mesh = D.global_mesh(devices=two)
    assert mesh.shape == {"dp": 2, "tp": 2}
    assert mesh.processes.tolist() == [[0, 0], [1, 1]]
    assert D.process_span(two) == 2


def _engine(workers, scheduler=tb.SchedulerType.FIXED_WORKER):
    b = tb.RuntimeConfigBuilder().add_scheduler(scheduler)
    for w in workers:
        b.add_worker(w)
    return tb.Engine.create(b.profile_warmups(0).profile_runs(1).build())


def test_transfer_cost_classes_ici_vs_dcn():
    eng = _engine([tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=(0,)),
                   tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=(1,))])
    try:
        mid = eng.register_model(tb.Model.from_path(FC))
        rec = eng.model_record(mid)
        unit = sorted(rec.boundary_bytes)[0] if rec.boundary_bytes else 0
        nbytes = rec.boundary_bytes.get(unit, 0)
        # pretend both are cards: card 0 and card 1 of one process (ICI)
        for w in eng.config.worker.workers:
            w.device = tb.DeviceFlag.GPU
        tables = eng._plan_workers
        tables.dev[:] = [0, 1]
        ici = eng.get_transfer_cost_us(mid, unit, 0, 1)
        # the second worker in another process: DCN, dearer
        tables.proc[:] = [0, 1]
        dcn = eng.get_transfer_cost_us(mid, unit, 0, 1)
        assert dcn > ici
        assert ici == DEFAULTS[ICI, 0] + nbytes // DEFAULTS[ICI, 1]
        assert dcn == DEFAULTS[DCN, 0] + nbytes // DEFAULTS[DCN, 1]
        # same worker is free
        assert eng.get_transfer_cost_us(mid, unit, 1, 1) == 0
    finally:
        eng.shutdown()


# ----------------------------------------------------------------------
# tests/test_spmd_channel.py: framing
# ----------------------------------------------------------------------
def test_frame_roundtrip():
    a, b = socket.socketpair()
    blobs = [
        np.arange(12, dtype=np.int64).reshape(3, 4),
        np.zeros((2, 2, 2), np.int8),
        np.asarray(3.5, np.float32),
    ]
    spmd._send_frame(a, spmd.OP_EXEC, 1, 2, 3, blobs)
    op, x, y, z, out = spmd._recv_frame(b)
    assert (op, x, y, z) == (spmd.OP_EXEC, 1, 2, 3)
    for orig, got in zip(blobs, out):
        assert got.dtype == orig.dtype
        np.testing.assert_array_equal(got, orig)
    a.close()
    b.close()


def test_frame_closed_socket_raises():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(ConnectionError):
        spmd._recv_frame(b)
    b.close()


def test_control_address_follows_the_coordinator():
    assert spmd.control_address("10.0.0.1:8476") == ("10.0.0.1", 9476)
    assert spmd.control_address("10.0.0.1:8476", 7000) == ("10.0.0.1",
                                                           7000)


# ----------------------------------------------------------------------
# caches
# ----------------------------------------------------------------------
def test_leader_cache_identity_and_lru():
    c = spmd._LeaderCache(capacity=2)
    x, y, z = np.ones(4), np.zeros(4), np.full(4, 2.0)
    cid_x = c.insert(x, x)
    cid_y = c.insert(y, y)
    assert c.lookup(y)[0] == cid_y
    hit = c.lookup(x)  # touch: y becomes the LRU entry
    assert hit is not None and hit[0] == cid_x and hit[1] is x
    c.insert(z, z)  # evicts the least recently used (y)
    assert c.lookup(y) is None
    assert c.lookup(x)[0] == cid_x
    assert c.lookup(z) is not None


def test_follower_cache_mirrors_lru():
    f = spmd._FollowerCache(capacity=2)
    f.insert(0, np.ones(1))
    f.insert(1, np.zeros(1))
    f.get(0)  # touch
    f.insert(2, np.full(1, 2.0))  # evicts 1
    assert 1 not in f._store
    np.testing.assert_array_equal(f.get(0), np.ones(1))


# ----------------------------------------------------------------------
# run_window
# ----------------------------------------------------------------------
class _PseudoFollower:
    """Reads frames from one end of a socketpair, recording per-frame
    payload sizes (no replay: a single-process mesh needs no peer)."""

    def __init__(self):
        self.leader_end, self.follower_end = socket.socketpair()
        self.frames = []
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        try:
            while True:
                op, a, b, c, blobs = spmd._recv_frame(self.follower_end)
                self.frames.append((op, a, b, c, [bl.nbytes for bl in blobs]))
        except (ConnectionError, OSError):
            return

    def wait(self, n):
        for _ in range(250):
            if len(self.frames) >= n:
                return
            time.sleep(0.02)

    def close(self):
        self.leader_end.close()
        self.follower_end.close()
        self._t.join(timeout=5)


def _fc_goldens():
    z = np.load(GOLDENS_PATH)
    xs = golden_inputs(int(z["fc_int8/seed"]), (1, 16, 16, 8), np.int8,
                       len(z["fc_int8/output"]))
    return xs, z["fc_int8/output"]


def _channel(eng, pairs, follower):
    channel = spmd.SpmdChannel(eng)
    channel._socks = [follower.leader_end]
    channel._sock_locks = [threading.Lock()]
    channel._slots = {key: i for i, (_, key) in enumerate(pairs)}
    channel._by_slot = list(pairs)
    return channel


@pytest.fixture
def mesh_engine():
    eng = _engine([tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=(0, 1),
                                 mesh_shape=(2, 1), max_batch=8)])
    try:
        yield eng
    finally:
        eng.shutdown()


def _mesh_key(eng):
    mid = eng.register_model(tb.Model.from_path(FC))
    ex = eng.model_record(mid).executors[0]
    return ex, ex.largest_subgraph_key()


def test_run_window_caches_payloads_to_metadata(mesh_engine):
    ex, key = _mesh_key(mesh_engine)
    follower = _PseudoFollower()
    channel = _channel(mesh_engine, [(ex, key)], follower)
    try:
        xs, want = _fc_goldens()
        staged = torch.from_numpy(xs[0])  # a staged serving tensor
        out1 = channel.run_window(ex, key, [[staged]] * 4)
        channel.run_window(ex, key, [[staged]] * 4)
        out3 = channel.run_window(ex, key, [[staged]] * 8)
        np.testing.assert_array_equal(out1[0][0].numpy(), want[0])
        np.testing.assert_array_equal(out3[7][0].numpy(), want[0])
        follower.wait(3)
        assert len(follower.frames) == 3
        sizes = [sum(f[4]) for f in follower.frames]
        # the first window ships the payload (ENC_STAGE), repeats are
        # metadata only (ENC_REF), even at a bigger bucket
        assert sizes[0] >= xs[0].nbytes
        assert sizes[1] < 200 and sizes[2] < 200, sizes
    finally:
        follower.close()


def test_run_window_novel_payloads_ship_rows(mesh_engine):
    """Novel per-request numpy payloads are never cached: each window
    ships raw rows (dp-sliced for the receiving process)."""
    ex, key = _mesh_key(mesh_engine)
    follower = _PseudoFollower()
    channel = _channel(mesh_engine, [(ex, key)], follower)
    try:
        xs, want = _fc_goldens()
        for lo in (0, 4):
            window = [[xs[i]] for i in range(lo, lo + 4)]
            outs = channel.run_window(ex, key, window)
            for i, o in enumerate(outs):
                np.testing.assert_array_equal(o[0].numpy(), want[lo + i])
        follower.wait(2)
        # every frame carries payload (no false cache hits on fresh
        # arrays, whose ids could recycle)
        assert len(follower.frames) == 2
        for f in follower.frames:
            assert sum(f[4]) > 0
    finally:
        follower.close()


def test_follower_loss_quarantines_and_raises(mesh_engine):
    """A dead pseudo-follower turns the next run_window into an
    ExecutionError and quarantines the worker (instead of wedging)."""
    ex, key = _mesh_key(mesh_engine)
    follower = _PseudoFollower()
    channel = _channel(mesh_engine, [(ex, key)], follower)
    xs, _ = _fc_goldens()
    assert channel.run_window(ex, key, [[xs[0]]])  # healthy first
    follower.follower_end.close()  # the follower "dies"
    follower.leader_end.close()
    with pytest.raises(tb.ExecutionError):
        for _ in range(3):  # a first send may land in the socket buffer
            channel.run_window(ex, key, [[xs[0]]])
    assert mesh_engine.workers[0]._quarantined


def test_two_worker_streams_pipeline_concurrently():
    """Per-worker pipelining: two mesh workers announced from two threads
    do not serialize on a shared control-plane lock.  While worker 0's
    channel is held (a long launch), worker 1's windows are announced and
    served; the follower sees worker 1's frames before worker 0's."""
    spec = dict(device=tb.DeviceFlag.CPU, mesh_shape=(2, 1), max_batch=8)
    eng = _engine([tb.WorkerSpec(device_ids=(0, 1), **spec),
                   tb.WorkerSpec(device_ids=(2, 3), **spec)])
    follower = _PseudoFollower()
    try:
        mid = eng.register_model(tb.Model.from_path(FC))
        rec = eng.model_record(mid)
        pairs = [(rec.executors[w], rec.executors[w].largest_subgraph_key())
                 for w in (0, 1)]
        channel = _channel(eng, pairs, follower)
        xs, want = _fc_goldens()
        n = 5
        done = [0, 0]

        def stream(i):
            for _ in range(n):
                outs = channel.run_window(*pairs[i], [[x] for x in xs[:4]])
                np.testing.assert_array_equal(outs[3][0].numpy(), want[3])
                done[i] += 1

        held = channel._worker_locks.setdefault(0, threading.Lock())
        held.acquire()  # worker 0 mid-launch
        t0 = threading.Thread(target=stream, args=(0,))
        t1 = threading.Thread(target=stream, args=(1,))
        t0.start()
        t1.start()
        t1.join(timeout=60)
        assert done == [0, n], done  # worker 1 went on, worker 0 waited
        held.release()
        t0.join(timeout=60)
        assert done == [n, n], done
        follower.wait(2 * n)
        assert [f[1] for f in follower.frames] == [1] * n + [0] * n
    finally:
        follower.close()
        eng.shutdown()
