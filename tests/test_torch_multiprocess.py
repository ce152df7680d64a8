"""One engine over two processes: a torch.distributed (gloo) cluster on
localhost, as tests/test_multiprocess_distributed.py and
tests/test_spmd_engine.py bring up band_tpu's, each process a simulated
host with one virtual CPU device (``local_device_ids`` [0]).

 * bring-up: process count and index, the global pool (one device a
   process), global_mesh's shape and process-major order, process_span;
 * a tp=2 mesh worker spanning both processes (device ids 0 and 1, and
   1 and 0) serves fc_int8 and effnetlite_int8 byte-equal to a
   single-device worker of the same engine and to the TFLite goldens, at
   b1 and in windows (the follower replays every launch through the SPMD
   control plane); a dp=2 mesh over both splits a window of 8 between
   them;
 * registration and unregistration through the live channel are
   replicated on the follower;
 * the benchmark tool's distributed branch reports from process 0, with
   a measured DCN row;
 * a follower killed mid-run quarantines the mesh worker and fails its
   jobs instead of hanging the leader.

Every subprocess has a timeout.  Run as a script, this file is one
process of the cluster: ``test_torch_multiprocess.py <coordinator>
<num_processes> <process_id> <mode>``.
"""

import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_cluster(mode: str, n_procs: int = 2):
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coord, str(n_procs),
             str(pid), mode],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(n_procs)
    ]
    outs, errs, rcs = {}, {}, {}
    try:
        for pid, p in enumerate(procs):
            outs[pid], errs[pid] = p.communicate(timeout=TIMEOUT_S)
            rcs[pid] = p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs, errs, rcs


def _result(out: str) -> dict:
    line = next(l for l in out.splitlines() if l.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def test_two_processes_serve_a_spanning_mesh():
    outs, errs, rcs = _run_cluster("serve")
    for pid in (0, 1):
        assert rcs[pid] == 0, f"p{pid}:\n{errs[pid][-4000:]}\n{outs[pid]}"
    r0, r1 = _result(outs[0]), _result(outs[1])
    for pid, r in enumerate((r0, r1)):
        assert r["pid"] == pid and r["process_count"] == 2
        assert r["global_cpu_devices"] == 2 and r["process_span"] == 2
        # auto-sized: tp = devices a process (1), dp = processes (2),
        # each tp row within one process
        assert r["mesh_shape"] == [2, 1] and r["mesh_processes"] == [[0], [1]]
        assert r["gathered"] == [0.0, 1.0]
    assert r0["served"] == ["fc_int8", "effnetlite_int8"]
    assert r0["equal_single"] and r0["equal_golden"], r0
    assert r0["hot_registered"] and r0["hot_unregistered"], r0
    # the follower ran the tp=2 shards: one gather a split op and request
    assert r1["gathers"] > 0 and r1["models_after"] == r0["models_after"]
    assert r0["windows"]["8"] >= 1, r0
    bench = r0["benchmark"]
    assert bench["total"]["processed"] > 0 and bench["total"]["canceled"] == 0
    assert "dcn" in bench["link_costs"], bench
    assert r1["benchmark"] is None


def test_killed_follower_quarantines_the_mesh():
    outs, errs, rcs = _run_cluster("kill")
    assert rcs[1] == 17, f"follower:\n{errs[1][-4000:]}\n{outs[1]}"
    assert rcs[0] == 0, f"leader:\n{errs[0][-4000:]}\n{outs[0]}"
    r = _result(outs[0])
    assert r["succeeded"] > 0 and r["failed"] > 0, r
    assert r["quarantined"] is True, r


# ----------------------------------------------------------------------
# one process of the cluster
# ----------------------------------------------------------------------
def _engine(tb, coord, n_procs, pid, workers, scheduler="fixed_worker"):
    from band_tpu_torch.config import config_from_dict

    cfg = config_from_dict({
        "schedulers": [scheduler],
        "workers": workers,
        "profile_num_warmups": 0,
        "profile_num_runs": 1,
        "distributed": {"coordinator_address": coord,
                        "num_processes": n_procs, "process_id": pid,
                        "local_device_ids": [0]},
    })
    return tb.Engine.create(cfg)


def _goldens(name):
    import numpy as np

    from band_tpu_torch.tflite.parser import parse_tflite_file
    from tests.gen_torch_goldens import GOLDENS_PATH, golden_inputs

    z = np.load(GOLDENS_PATH)
    g = parse_tflite_file(os.path.join(DATA, f"{name}.tflite"))
    td = g.tensor(g.inputs[0])
    want = z[f"{name}/output"]
    return golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype,
                         len(want)), want


def _serve(coord, n_procs, pid):
    import numpy as np
    import torch

    import band_tpu_torch as tb
    from band_tpu_torch.parallel import distributed as D
    from band_tpu_torch.parallel.mesh import collective_stats
    from band_tpu_torch.parallel.spmd import SpmdChannel
    from band_tpu_torch.tools.benchmark import BenchmarkConfig, run_distributed

    models = ("fc_int8", "effnetlite_int8")
    eng = _engine(tb, coord, n_procs, pid, [
        {"device": "cpu", "device_ids": [0, 1], "mesh_shape": [1, 2],
         "max_batch": 8},
        {"device": "cpu", "device_ids": [0, 1], "mesh_shape": [2, 1],
         "max_batch": 8},
        {"device": "cpu", "device_ids": [0]},
        # tp=2 with its columns against process order: gathered blocks
        # arrive by rank and are reordered by column
        {"device": "cpu", "device_ids": [1, 0], "mesh_shape": [1, 2],
         "max_batch": 8},
    ])
    res = {"pid": pid, "process_count": D.process_count(),
           "global_cpu_devices": len(D.devices("cpu"))}
    mesh = D.global_mesh()
    res["mesh_shape"] = [mesh.shape["dp"], mesh.shape["tp"]]
    res["mesh_processes"] = mesh.processes.tolist()
    res["process_span"] = D.process_span(D.devices("cpu"))
    res["gathered"] = [float(t) for t in D.all_gather(
        torch.tensor([float(pid)]), torch.distributed.group.WORLD)]
    mids = [eng.register_model(tb.Model.from_path(
        os.path.join(DATA, f"{m}.tflite"))) for m in models]
    channel = SpmdChannel(eng, coordinator_address=coord)
    channel.barrier()
    try:
        if pid != 0:
            channel.run_follower()
            res["gathers"] = collective_stats()["gathers"]
            res["models_after"] = sorted(eng.list_models())
        else:
            channel.attach()
            equal_single = equal_golden = True
            for m, mid in zip(models, mids):
                xs, want = _goldens(m)
                for w in (0, 1, 3):
                    opt = tb.RequestOption(target_worker=w)
                    for i, x in enumerate(xs[:2]):
                        out = eng.request_sync(mid, [x], opt)[0]
                        single = eng.request_sync(
                            mid, [x], tb.RequestOption(target_worker=2))[0]
                        equal_single &= bool(np.array_equal(out, single))
                        equal_golden &= bool(np.array_equal(out, want[i]))
                    ids = eng.request_async_batch(
                        [mid] * 8, [[x] for x in xs], [opt] * 8)
                    eng.wait_all(ids, timeout=60, raise_on_incomplete=True)
                    for i, jid in enumerate(ids):
                        equal_golden &= bool(np.array_equal(
                            eng.get_outputs(jid)[0], want[i]))
            res.update(served=list(models), equal_single=equal_single,
                       equal_golden=equal_golden)
            dp_ex = eng.model_record(mids[0]).executors[1]
            res["windows"] = {str(k): v for k, v in dp_ex.windows.items()}
            # hot registration through the live channel
            xs, want = _goldens("resnetish_int8")
            mid = channel.register_model(
                os.path.join(DATA, "resnetish_int8.tflite"), target_worker=0)
            out = eng.request_sync(mid, [xs[0]],
                                   tb.RequestOption(target_worker=0))[0]
            res["hot_registered"] = bool(np.array_equal(out, want[0]))
            channel.unregister_model(mid)
            res["hot_unregistered"] = mid not in eng.list_models()
            res["models_after"] = sorted(eng.list_models())
            channel.shutdown_followers()
    finally:
        eng.shutdown()
    # the benchmark tool's distributed branch: the same config on both
    report = run_distributed(BenchmarkConfig.from_dict({
        "models": [{"graph": os.path.join(DATA, "fc_int8.tflite"),
                    "period_ms": 5, "batch_size": 2}],
        "schedulers": ["fixed_worker"],
        "workers": [{"device": "cpu", "device_ids": [0, 1],
                     "mesh_shape": [1, 2], "max_batch": 4}],
        "running_time_ms": 400, "profile_num_warmups": 0,
        "profile_num_runs": 1, "execution_mode": "periodic",
        "distributed": {"coordinator_address": coord,
                        "num_processes": n_procs, "process_id": pid,
                        "control_port": _port_after(coord, 2000),
                        "local_device_ids": [0]},
    }))
    res["benchmark"] = report
    print("RESULT" + json.dumps(res), flush=True)


def _port_after(coord: str, k: int) -> int:
    return int(coord.rpartition(":")[2]) + k


def _kill(coord, n_procs, pid):
    import time

    import numpy as np

    import band_tpu_torch as tb
    from band_tpu_torch.common import JobStatus
    from band_tpu_torch.parallel.spmd import SpmdChannel

    eng = _engine(tb, coord, n_procs, pid, [
        {"device": "cpu", "device_ids": [0, 1], "mesh_shape": [1, 2],
         "max_batch": 4}], scheduler="least_slack_time_first")
    mid = eng.register_model(tb.Model.from_path(
        os.path.join(DATA, "fc_int8.tflite")))
    channel = SpmdChannel(eng, coordinator_address=coord)
    channel.barrier()
    if pid != 0:
        # abort abruptly partway into the serving run: after the third
        # window this process replayed
        replay, done = channel._replay_exec, []

        def replay_then_die(*args):
            replay(*args)
            done.append(1)
            if len(done) == 3:
                os._exit(17)

        channel._replay_exec = replay_then_die
        try:
            channel.run_follower()
        finally:
            os._exit(17)
    channel.attach()
    xs, _ = _goldens("fc_int8")
    opt = tb.RequestOption(slo_us=1_000_000)
    counts = {"succeeded": 0, "failed": 0}
    end = time.monotonic() + 60.0
    while time.monotonic() < end and not (
            counts["failed"] and eng.workers[0]._quarantined):
        ids = eng.request_async_batch([mid] * 4, [[x] for x in xs[:4]],
                                      [opt] * 4)
        st = eng.wait_all(ids, timeout=30)
        for jid in ids:
            ok = st.get(jid) == JobStatus.SUCCESS
            counts["succeeded" if ok else "failed"] += 1
        time.sleep(0.02)
    counts["quarantined"] = bool(eng.workers[0]._quarantined)
    print("RESULT" + json.dumps(counts), flush=True)
    # skip teardown: the process group's peer is gone
    os._exit(0)


def main() -> None:
    coord, n_procs, pid, mode = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, REPO)
    {"serve": _serve, "kill": _kill}[mode](coord, n_procs, pid)


if __name__ == "__main__":
    main()
