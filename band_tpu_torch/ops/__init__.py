"""Op lowerings, int64 quantization arithmetic and the CUDA kernels.

Importing this package populates the lowering registry (the
``@register`` decorators run at import of ``lowerings``)."""

from . import lowerings  # noqa: F401
from .registry import REGISTRY, get_lowering, is_supported  # noqa: F401
