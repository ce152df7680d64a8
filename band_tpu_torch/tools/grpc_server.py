"""gRPC serving front-end.

A port of band_tpu/tools/grpc_server.py over the port's engine, with
the same service (``band.BandEngine``) and messages (band_grpc.proto),
so a client of either package talks to a server of the other.  The
reference's README advertises a gRPC interface it never implements;
this is the real one, exposing the same engine surface as the HTTP
front-end (tools/server.py) plus a pipelined bidirectional request
stream.

The service is wired with generic method handlers over protoc-generated
message classes (``band_grpc_pb2.py``, generated from
``band_grpc.proto`` — regen command in the proto header), so no
grpcio-tools is needed. Clients in other languages codegen from the
proto; Python clients use :class:`BandGrpcClient` below.  This module
needs ``grpcio`` and ``protobuf``; nothing else of the package imports
it.

Usage: python -m band_tpu_torch.tools.grpc_server --config cfg.json --port 8501
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
from concurrent import futures
from typing import Iterator, Optional, Tuple

import numpy as np

from ..common import RequestOption
from ..config import RuntimeConfig, config_from_json
from ..errors import BandError, DeadlineExceeded, NotFound
from ..ir.model import Model
from ..runtime.engine import Engine
from . import band_grpc_pb2 as pb

import grpc

_SERVICE = "band.BandEngine"
_DEFAULT_TIMEOUT_S = 60.0


def encode_tensor(arr: np.ndarray) -> pb.Tensor:
    arr = np.ascontiguousarray(arr)
    return pb.Tensor(
        shape=list(arr.shape), dtype=str(arr.dtype), data=arr.tobytes()
    )


def decode_tensor(t: pb.Tensor) -> np.ndarray:
    try:
        dt = np.dtype(t.dtype)
    except TypeError as e:
        raise ValueError(f"bad dtype {t.dtype!r}: {e}") from None
    return np.frombuffer(t.data, dtype=dt).reshape(list(t.shape))


def _option_from(req: pb.InferRequest) -> RequestOption:
    return RequestOption(
        slo_us=int(req.slo_us) if req.slo_us > 0 else -1,
        slo_scale=float(req.slo_scale) if req.slo_scale > 0 else -1.0,
        target_worker=(
            req.target_worker if req.HasField("target_worker") else -1
        ),
    )


def _timeout_of(v: float) -> float:
    return float(v) if v > 0 else _DEFAULT_TIMEOUT_S


class BandGrpcService:
    """Engine-backed servicer; every method maps engine errors to grpc
    status codes (INVALID_ARGUMENT / NOT_FOUND / DEADLINE_EXCEEDED) so a
    malformed request never kills the connection."""

    def __init__(self, config: RuntimeConfig):
        self.engine = Engine.create(config)
        self._lock = threading.Lock()

    # --- unary handlers -------------------------------------------------
    def Health(self, request: pb.Empty, context) -> pb.HealthReply:
        return pb.HealthReply(
            status="ok", num_workers=self.engine.num_workers()
        )

    def ListModels(self, request: pb.Empty, context) -> pb.ModelTable:
        table = pb.ModelTable()
        for mid, rec in self.engine.list_models().items():
            g = rec.model.graph
            info = table.models.add(
                model_id=mid,
                name=rec.model.name,
                worker=rec.worker_id,
                subgraphs=len(rec.subgraph_keys),
            )
            for tid in g.inputs:
                info.inputs.add(
                    index=tid,
                    shape=list(g.tensor(tid).shape),
                    dtype=str(g.tensor(tid).dtype),
                )
            for tid in g.outputs:
                info.outputs.add(
                    index=tid,
                    shape=list(g.tensor(tid).shape),
                    dtype=str(g.tensor(tid).dtype),
                )
        return table

    def RegisterModel(
        self, request: pb.RegisterRequest, context
    ) -> pb.RegisterReply:
        if not request.path:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "missing path")
        target = (
            request.target_worker
            if request.HasField("target_worker")
            else -1
        )
        try:
            with self._lock:
                mid = self.engine.register_model(
                    Model.from_path(request.path), target_worker=target
                )
        except (OSError, BandError, ValueError, TypeError) as e:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, f"register failed: {e}"
            )
        return pb.RegisterReply(model_id=mid)

    def UnregisterModel(self, request: pb.ModelId, context) -> pb.Empty:
        try:
            with self._lock:
                self.engine.unregister_model(request.model_id)
        except BandError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return pb.Empty()

    def _submit(self, request: pb.InferRequest, context) -> int:
        try:
            inputs = [decode_tensor(t) for t in request.inputs]
            return self.engine.request_async(
                request.model_id, inputs, _option_from(request)
            )
        except (BandError, ValueError, TypeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def _fetch(
        self, job_id: int, timeout_s: float, context, seq: int = 0
    ) -> pb.InferReply:
        try:
            outs = self.engine.wait(job_id, timeout=timeout_s)
        except TimeoutError:
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "timeout")
        except DeadlineExceeded:
            context.abort(
                grpc.StatusCode.DEADLINE_EXCEEDED, "slo_violation"
            )
        except NotFound as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except (BandError, ValueError, TypeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.InferReply(
            outputs=[encode_tensor(o) for o in outs], seq=seq, job_id=job_id
        )

    def Request(self, request: pb.InferRequest, context) -> pb.InferReply:
        jid = self._submit(request, context)
        return self._fetch(
            jid, _timeout_of(request.timeout_s), context, seq=request.seq
        )

    def RequestAsync(self, request: pb.InferRequest, context) -> pb.JobId:
        return pb.JobId(job_id=self._submit(request, context))

    def Wait(self, request: pb.WaitRequest, context) -> pb.InferReply:
        return self._fetch(
            request.job_id, _timeout_of(request.timeout_s), context
        )

    def Stats(self, request: pb.Empty, context) -> pb.StatsReply:
        reply = pb.StatsReply()
        counts = self.engine.get_model_execution_counts()
        for mid, rec in self.engine.list_models().items():
            ms = reply.models[mid]
            ms.execution_count = counts.get(mid, 0)
            for k in rec.subgraph_keys:
                ms.expected_latency_us[str(k)] = (
                    self.engine.get_expected_latency(k)
                )
        return reply

    def _fetch_stream(
        self, job_id: int, timeout_s: float, seq: int
    ) -> pb.InferReply:
        """Non-aborting fetch for the streaming path: failures become a
        per-reply status (InferReply.code/error) so one bad request
        never tears down a pipelined connection."""
        try:
            outs = self.engine.wait(job_id, timeout=timeout_s)
        except TimeoutError:
            return pb.InferReply(
                seq=seq, job_id=job_id,
                code=grpc.StatusCode.DEADLINE_EXCEEDED.value[0],
                error="timeout",
            )
        except DeadlineExceeded:
            return pb.InferReply(
                seq=seq, job_id=job_id,
                code=grpc.StatusCode.DEADLINE_EXCEEDED.value[0],
                error="slo_violation",
            )
        except NotFound as e:
            return pb.InferReply(
                seq=seq, job_id=job_id,
                code=grpc.StatusCode.NOT_FOUND.value[0], error=str(e),
            )
        except (BandError, ValueError, TypeError) as e:
            return pb.InferReply(
                seq=seq, job_id=job_id,
                code=grpc.StatusCode.INVALID_ARGUMENT.value[0],
                error=str(e),
            )
        return pb.InferReply(
            outputs=[encode_tensor(o) for o in outs], seq=seq,
            job_id=job_id,
        )

    # --- streaming ------------------------------------------------------
    def StreamRequests(
        self, request_iterator: Iterator[pb.InferRequest], context
    ) -> Iterator[pb.InferReply]:
        """Pipelined inference: submit every incoming request to the
        engine immediately (a feeder thread drains the request stream so
        submission never waits on reply fetching), yield replies in
        submission order. Later requests execute while earlier replies
        are still being fetched, which keeps the engine's
        continuous-batching window full from a single connection.

        Per-request failures (decode, submit, wait) come back as replies
        with InferReply.code set; the stream itself only ends when the
        client closes it or the transport dies."""
        # queue items: (job_id | None, seq, timeout_s, code, error)
        pending: "queue.Queue[Optional[Tuple]]" = queue.Queue()

        def _feed():
            try:
                for req in request_iterator:
                    try:
                        inputs = [decode_tensor(t) for t in req.inputs]
                        jid = self.engine.request_async(
                            req.model_id, inputs, _option_from(req)
                        )
                    except (BandError, ValueError, TypeError) as e:
                        # reply-with-error, keep feeding later requests
                        pending.put((
                            None, req.seq, 0.0,
                            grpc.StatusCode.INVALID_ARGUMENT.value[0],
                            str(e),
                        ))
                        continue
                    pending.put(
                        (jid, req.seq, _timeout_of(req.timeout_s), 0, "")
                    )
            finally:
                pending.put(None)

        feeder = threading.Thread(target=_feed, daemon=True)
        feeder.start()
        try:
            while True:
                item = pending.get()
                if item is None:
                    break
                jid, seq, timeout_s, code, error = item
                if jid is None:
                    yield pb.InferReply(seq=seq, code=code, error=error)
                else:
                    yield self._fetch_stream(jid, timeout_s, seq)
        finally:
            # client cancelled / transport died mid-stream: the feeder
            # may still be submitting.  Drain whatever it queued so
            # finished records don't linger in the planner ring, then
            # join it (the request_iterator raises on a dead context, so
            # the feeder terminates promptly).
            feeder.join(timeout=30)
            leftovers = []
            while True:
                try:
                    item = pending.get_nowait()
                except queue.Empty:
                    break
                if item is not None and item[0] is not None:
                    leftovers.append(item[0])
            if leftovers:
                self.engine.wait_all(leftovers, timeout=5)
                self.engine.planner.discard_finished(leftovers)

    def shutdown(self):
        self.engine.shutdown()


def _handlers(svc: BandGrpcService) -> grpc.GenericRpcHandler:
    def unary(fn, req_cls, resp_cls):
        return grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )

    methods = {
        "Health": unary(svc.Health, pb.Empty, pb.HealthReply),
        "ListModels": unary(svc.ListModels, pb.Empty, pb.ModelTable),
        "RegisterModel": unary(
            svc.RegisterModel, pb.RegisterRequest, pb.RegisterReply
        ),
        "UnregisterModel": unary(
            svc.UnregisterModel, pb.ModelId, pb.Empty
        ),
        "Request": unary(svc.Request, pb.InferRequest, pb.InferReply),
        "RequestAsync": unary(
            svc.RequestAsync, pb.InferRequest, pb.JobId
        ),
        "Wait": unary(svc.Wait, pb.WaitRequest, pb.InferReply),
        "Stats": unary(svc.Stats, pb.Empty, pb.StatsReply),
        "StreamRequests": grpc.stream_stream_rpc_method_handler(
            svc.StreamRequests,
            request_deserializer=pb.InferRequest.FromString,
            response_serializer=pb.InferReply.SerializeToString,
        ),
    }
    return grpc.method_handlers_generic_handler(_SERVICE, methods)


def serve_grpc(
    config: RuntimeConfig, port: int = 0, max_workers: int = 16
) -> Tuple[BandGrpcService, grpc.Server, int]:
    """Create engine + grpc server; returns (service, server, bound port).
    port=0 picks a free port. Caller runs server.stop() + service
    .shutdown()."""
    svc = BandGrpcService(config)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers)
    )
    server.add_generic_rpc_handlers((_handlers(svc),))
    bound = server.add_insecure_port(f"0.0.0.0:{port}")
    server.start()
    return svc, server, bound


class BandGrpcClient:
    """Minimal Python client over a grpc channel (no codegen needed)."""

    def __init__(self, target: str):
        self._channel = grpc.insecure_channel(target)

        def unary(name, req_cls, resp_cls):
            return self._channel.unary_unary(
                f"/{_SERVICE}/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )

        self.health = unary("Health", pb.Empty, pb.HealthReply)
        self.list_models = unary("ListModels", pb.Empty, pb.ModelTable)
        self.register_model = unary(
            "RegisterModel", pb.RegisterRequest, pb.RegisterReply
        )
        self.unregister_model = unary(
            "UnregisterModel", pb.ModelId, pb.Empty
        )
        self.request = unary("Request", pb.InferRequest, pb.InferReply)
        self.request_async = unary(
            "RequestAsync", pb.InferRequest, pb.JobId
        )
        self.wait = unary("Wait", pb.WaitRequest, pb.InferReply)
        self.stats = unary("Stats", pb.Empty, pb.StatsReply)
        self.stream_requests = self._channel.stream_stream(
            f"/{_SERVICE}/StreamRequests",
            request_serializer=pb.InferRequest.SerializeToString,
            response_deserializer=pb.InferReply.FromString,
        )

    def close(self):
        self._channel.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--port", type=int, default=8501)
    args = ap.parse_args(argv)
    svc, server, port = serve_grpc(config_from_json(args.config), args.port)
    print(f"band-tpu-torch grpc serving on :{port}")
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop(grace=2)
        svc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
