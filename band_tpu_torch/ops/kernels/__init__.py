"""Hand-written Hopper kernels of the int8 serving path.

Each module holds a kernel's wrapper (device, dtype, shape and
contiguity checks, then a ctypes launch on PyTorch's current stream),
its launch count, and its plain PyTorch version.  A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the
kernel or raises.  ``build`` compiles ``csrc/*.cu`` with nvcc at first
use; importing this package compiles nothing.

==========  =========================  =======================================
kernel      wrapper                    replaces
==========  =========================  =======================================
B0          csrc/requant.cuh           band_tpu/ops/quant.py:286,327,344 (traced in B1-B4)
B1          qmatmul.qmatmul_exact      band_tpu/ops/pallas/qmatmul.py:135
B2          qconv.qconv2d_exact        band_tpu/ops/pallas/qconv.py:152
B3          qdwconv.qdwconv2d_exact    band_tpu/ops/pallas/qdwconv.py:114
B4          qmatmul.qmatmul_fast       band_tpu/ops/pallas/qmatmul.py:42
B2 fast     qconv.qconv2d_fast         band_tpu/ops/lowerings.py:563-575 (XLA conv + requantize_fast)
B2 mma      csrc/qconv_mma.cuh         B2's and B2 fast's general branch (counted apart as well)
B3 fast     qdwconv.qdwconv2d_fast     band_tpu/ops/lowerings.py:943-964 (XLA conv + requantize_fast)
softmax     softmax.lut_softmax        band_tpu/ops/quant.py:443 (XLA, no Pallas)
==========  =========================  =======================================
"""

from .qconv import (qconv2d_exact, qconv2d_fast, qconv2d_fast_plain,  # noqa: F401
                    qconv2d_plain)
from .qdwconv import (qdwconv2d_exact, qdwconv2d_fast,  # noqa: F401
                      qdwconv2d_fast_plain, qdwconv2d_plain)
from .qmatmul import (gemm_plan, qmatmul_exact, qmatmul_fast,  # noqa: F401
                      qmatmul_fast_plain, qmatmul_plain)
from .softmax import lut_softmax, lut_softmax_plain  # noqa: F401
from . import qconv as _qc, qdwconv as _qd, qmatmul as _qm, softmax as _sm
from .common import recording  # noqa: F401

# launch counts by kernel name (each a LaunchCount with a plain int ``n``)
LAUNCHES = {
    c.name: c
    for c in (_qm.launches, _qc.launches, _qd.launches, _sm.launches,
              _qm.fast_launches, _qc.fast_launches, _qd.fast_launches,
              _qc.mma_launches, _qc.fast_mma_launches)
}


def reset_launches() -> None:
    for c in LAUNCHES.values():
        c.reset()


def launch_counts() -> dict:
    return {name: c.n for name, c in LAUNCHES.items()}


def add_launches(tally: dict) -> None:
    """Count one replay of a CUDA graph whose capture made the kernel
    calls ``tally`` ({kernel name: calls}, from ``recording``)."""
    for name, k in tally.items():
        LAUNCHES[name].add(k)
