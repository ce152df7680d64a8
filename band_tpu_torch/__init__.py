"""band-tpu-torch: the PyTorch and CUDA build of band-tpu.

Serves INT8/UINT8 TFLite CNNs on an NVIDIA card through the same public
API as ``band_tpu``, with outputs byte-identical to it (and so to the
TFLite interpreter).  Every int8 CONV_2D, DEPTHWISE_CONV_2D and
FULLY_CONNECTED runs a CUDA kernel written for Hopper
(``ops/kernels/csrc``); a CPU worker runs the kernels' plain PyTorch
versions.  This package imports neither jax nor ``band_tpu``.

Quick start::

    import band_tpu_torch as bt

    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType.FIXED_WORKER)
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU, device_ids=(0,)))
           .build())
    engine = bt.Engine.create(cfg)
    model = bt.Model.from_path("tests/data/mobilenet_v2_int8.tflite")
    mid = engine.register_model(model)
    outputs = engine.request_sync(mid, [image_i8])
"""

from .common import (  # noqa: F401
    DeviceFlag,
    Job,
    JobStatus,
    RequestOption,
    SchedulerType,
    SubgraphKey,
    SubgraphPreparationType,
    WorkerType,
)
from .config import (  # noqa: F401
    PlannerConfig,
    ProfileConfig,
    RuntimeConfig,
    RuntimeConfigBuilder,
    SubgraphConfig,
    WorkerConfig,
    WorkerSpec,
    config_from_dict,
    config_from_json,
)
from .errors import (  # noqa: F401
    BandError,
    ConfigError,
    DeadlineExceeded,
    ExecutionError,
    LoweringError,
    ModelError,
    NotFound,
)
from .ir.model import Model  # noqa: F401
from .runtime.engine import Engine  # noqa: F401
from .runtime.tensor import StagedInput, Tensor  # noqa: F401
from .tracing.job_tracer import tracer  # noqa: F401

__version__ = "0.1.0"
