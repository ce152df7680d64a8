"""The port's gRPC front-end (band_tpu_torch/tools/grpc_server.py) over a
real channel on a CPU worker and tests/data models: register,
sync/async/wait, stats, unregister, the pipelined bidirectional stream, a
bad request inside a stream, error-status mapping, a quarantined worker,
and wire compatibility with band_tpu's messages and client.  Outputs are
held byte-equal to tests/data/torch_goldens.npz (TFLite)."""

import threading

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from band_tpu.tools import band_grpc_pb2 as jpb
from band_tpu_torch.tools import band_grpc_pb2 as pb
from band_tpu_torch.tools.grpc_server import (
    BandGrpcClient,
    decode_tensor,
    encode_tensor,
    serve_grpc,
)
from tests.test_torch_frontends import FC_PATH, MODEL_PATH, _cfg, _goldens


@pytest.fixture
def grpc_engine():
    svc, server, port = serve_grpc(_cfg(), port=0)
    client = BandGrpcClient(f"127.0.0.1:{port}")
    yield client
    client.close()
    server.stop(grace=None)
    svc.shutdown()


def test_grpc_round_trip(grpc_engine):
    c = grpc_engine
    xs, want = _goldens()
    health = c.health(pb.Empty())
    assert health.status == "ok" and health.num_workers == 1
    mid = c.register_model(pb.RegisterRequest(path=MODEL_PATH)).model_id
    table = c.list_models(pb.Empty())
    assert [m.model_id for m in table.models] == [mid]
    assert table.models[0].inputs[0].dtype == "int8"
    assert list(table.models[0].inputs[0].shape) == [1, 64, 64, 3]
    out = c.request(pb.InferRequest(model_id=mid,
                                    inputs=[encode_tensor(xs[0])], seq=42))
    assert out.seq == 42
    np.testing.assert_array_equal(decode_tensor(out.outputs[0]), want[0])
    jid = c.request_async(
        pb.InferRequest(model_id=mid, inputs=[encode_tensor(xs[1])])).job_id
    out = c.wait(pb.WaitRequest(job_id=jid))
    np.testing.assert_array_equal(decode_tensor(out.outputs[0]), want[1])
    stats = c.stats(pb.Empty())
    assert stats.models[mid].execution_count >= 2
    assert len(stats.models[mid].expected_latency_us) >= 1


def test_grpc_stream_pipelined(grpc_engine):
    c = grpc_engine
    xs, want = _goldens()
    mid = c.register_model(pb.RegisterRequest(path=MODEL_PATH)).model_id
    reqs = (pb.InferRequest(model_id=mid, inputs=[encode_tensor(x)], seq=i)
            for i, x in enumerate(xs))
    replies = list(c.stream_requests(reqs))
    assert [r.seq for r in replies] == list(range(len(xs)))
    for r, w in zip(replies, want):
        assert r.code == 0
        np.testing.assert_array_equal(decode_tensor(r.outputs[0]), w)


def test_grpc_errors(grpc_engine):
    c = grpc_engine
    x = np.zeros((1, 16, 16, 8), np.int8)
    with pytest.raises(grpc.RpcError) as ei:
        c.request(pb.InferRequest(model_id=99, inputs=[encode_tensor(x)]))
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as ei:
        c.register_model(pb.RegisterRequest(path="/nonexistent.tflite"))
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as ei:
        c.register_model(pb.RegisterRequest())
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    mid = c.register_model(pb.RegisterRequest(path=FC_PATH)).model_id
    with pytest.raises(grpc.RpcError) as ei:
        c.request(pb.InferRequest(
            model_id=mid,
            inputs=[pb.Tensor(shape=[2], dtype="float32", data=b"\x00")]))
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as ei:
        c.request(pb.InferRequest(
            model_id=mid, inputs=[pb.Tensor(shape=[1], dtype="nonsense",
                                            data=b"\x00")]))
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as ei:
        c.wait(pb.WaitRequest(job_id=10_000, timeout_s=0.05))
    assert ei.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
    with pytest.raises(grpc.RpcError) as ei:
        c.unregister_model(pb.ModelId(model_id=77))
    assert ei.value.code() == grpc.StatusCode.NOT_FOUND


def test_grpc_unregister_flow(grpc_engine):
    c = grpc_engine
    xs, want = _goldens("fc_int8")
    mid = c.register_model(pb.RegisterRequest(path=FC_PATH)).model_id
    c.request(pb.InferRequest(model_id=mid, inputs=[encode_tensor(xs[0])]))
    c.unregister_model(pb.ModelId(model_id=mid))
    assert len(c.list_models(pb.Empty()).models) == 0
    with pytest.raises(grpc.RpcError) as ei:
        c.request(pb.InferRequest(model_id=mid,
                                  inputs=[encode_tensor(xs[0])]))
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    mid2 = c.register_model(pb.RegisterRequest(path=FC_PATH)).model_id
    out = c.request(pb.InferRequest(model_id=mid2,
                                    inputs=[encode_tensor(xs[2])]))
    np.testing.assert_array_equal(decode_tensor(out.outputs[0]), want[2])


def test_grpc_stream_survives_bad_requests(grpc_engine):
    """A malformed or unknown-model request inside a pipelined stream
    gets a per-reply error status (InferReply.code) and the stream keeps
    serving later requests."""
    c = grpc_engine
    xs, want = _goldens("fc_int8")
    mid = c.register_model(pb.RegisterRequest(path=FC_PATH)).model_id

    def reqs():
        yield pb.InferRequest(model_id=mid, inputs=[encode_tensor(xs[0])],
                              seq=0)
        yield pb.InferRequest(model_id=99, inputs=[encode_tensor(xs[0])],
                              seq=1)
        yield pb.InferRequest(
            model_id=mid,
            inputs=[pb.Tensor(shape=[2], dtype="float32", data=b"\x00")],
            seq=2)
        yield pb.InferRequest(model_id=mid, inputs=[encode_tensor(xs[3])],
                              seq=3)

    replies = list(c.stream_requests(reqs()))
    assert [r.seq for r in replies] == [0, 1, 2, 3]
    assert replies[0].code == 0 and replies[3].code == 0
    np.testing.assert_array_equal(decode_tensor(replies[0].outputs[0]),
                                  want[0])
    np.testing.assert_array_equal(decode_tensor(replies[3].outputs[0]),
                                  want[3])
    assert replies[1].code == grpc.StatusCode.INVALID_ARGUMENT.value[0]
    assert replies[2].code == grpc.StatusCode.INVALID_ARGUMENT.value[0]
    assert not replies[1].outputs and replies[1].error


def test_grpc_quarantined_worker_jobs_fail_explicitly():
    """Jobs stuck on a watchdog-quarantined worker come back as explicit
    per-reply failures through the stream, not hangs or missing seqs."""
    svc, server, port = serve_grpc(_cfg(stuck_timeout_ms=300), port=0)
    client = BandGrpcClient(f"127.0.0.1:{port}")
    blocker = threading.Event()
    try:
        mid = client.register_model(
            pb.RegisterRequest(path=FC_PATH)).model_id
        x = np.zeros((1, 16, 16, 8), np.int8)
        w0 = svc.engine.workers[0]
        orig = w0._dispatch

        def wedged(jobs, *a, **kw):
            blocker.wait(30.0)
            return orig(jobs, *a, **kw)

        w0._dispatch = wedged
        reqs = (pb.InferRequest(model_id=mid, inputs=[encode_tensor(x)],
                                seq=i, timeout_s=3.0) for i in range(3))
        replies = list(client.stream_requests(reqs))
        blocker.set()
        assert [r.seq for r in replies] == [0, 1, 2]
        assert all(r.code != 0 for r in replies)
    finally:
        blocker.set()
        client.close()
        server.stop(grace=None)
        svc.shutdown()


def test_wire_compatible_with_band_tpu():
    """Both packages register the same band_grpc.proto (the protobuf
    runtime takes the identical second registration), messages
    serialize to the same bytes, and band_tpu's client talks to the
    port's server."""
    from band_tpu.tools.grpc_server import BandGrpcClient as JClient

    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    xs, want = _goldens()
    t = encode_tensor(xs[0])
    for mine, theirs in (
        (pb.InferRequest(model_id=3, inputs=[t], seq=9, slo_us=5,
                         target_worker=0),
         jpb.InferRequest(model_id=3, inputs=[jpb.Tensor(
             shape=list(xs[0].shape), dtype="int8", data=xs[0].tobytes())],
             seq=9, slo_us=5, target_worker=0)),
        (pb.RegisterRequest(path=MODEL_PATH),
         jpb.RegisterRequest(path=MODEL_PATH)),
        (pb.WaitRequest(job_id=4, timeout_s=1.5),
         jpb.WaitRequest(job_id=4, timeout_s=1.5)),
    ):
        assert mine.SerializeToString(deterministic=True) == (
            theirs.SerializeToString(deterministic=True))
    svc, server, port = serve_grpc(_cfg(), port=0)
    client = JClient(f"127.0.0.1:{port}")
    try:
        mid = client.register_model(
            jpb.RegisterRequest(path=MODEL_PATH)).model_id
        out = client.request(jpb.InferRequest(
            model_id=mid, inputs=[jpb.Tensor.FromString(
                t.SerializeToString())]))
        got = np.frombuffer(out.outputs[0].data, out.outputs[0].dtype)
        np.testing.assert_array_equal(
            got.reshape(list(out.outputs[0].shape)), want[0])
    finally:
        client.close()
        server.stop(grace=None)
        svc.shutdown()
