"""Host-side tensor: the engine-owned deep-copy tensor handed across the
API boundary (reference: band/tensor.h:82-105, band/interface/tensor.cc
CopyDataFrom)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..ir.graph import QuantParams, TensorDef


class StagedInput:
    """An input staged on one or more devices plus host memory.

    Workers pick the copy on their own device, so a scheduler moving a
    job between workers never forces a transfer on the dispatch path."""

    def __init__(self, host: np.ndarray):
        self.host = np.asarray(host)
        self._copies = {}

    def stage(self, device) -> "StagedInput":
        import torch

        from ..backend.executor import to_device

        device = torch.device(device)
        if device not in self._copies:
            self._copies[device] = to_device(self.host, device)
        return self

    def for_device(self, device):
        """The copy on exactly this device; else any copy on a device of
        the same type (the caller moves it if needed); else host memory."""
        import torch

        device = torch.device(device)
        exact = self._copies.get(device)
        if exact is not None:
            return exact
        for dev, arr in self._copies.items():
            if dev.type == device.type:
                return arr
        return self.host


@dataclass
class Tensor:
    name: str
    data: np.ndarray
    quant: Optional[QuantParams] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> np.dtype:
        return self.data.dtype

    @staticmethod
    def from_def(td: TensorDef) -> "Tensor":
        return Tensor(
            name=td.name,
            data=np.zeros([max(s, 1) for s in td.shape], td.dtype),
            quant=td.quant,
        )

    def copy_from(self, other: "Tensor") -> None:
        """Deep copy with shape/dtype check (reference ITensor::CopyDataFrom)."""
        if other.data.shape != self.data.shape or other.dtype != self.dtype:
            raise ValueError(
                f"tensor copy mismatch: {other.data.shape}/{other.dtype} -> "
                f"{self.data.shape}/{self.dtype}"
            )
        np.copyto(self.data, other.data)

    def dequantized(self) -> np.ndarray:
        if self.quant is None or self.data.dtype.kind == "f":
            return self.data.astype(np.float32)
        scale = np.asarray(self.quant.scale, np.float32)
        zp = np.asarray(self.quant.zero_point, np.float32)
        if scale.size > 1:
            # per-channel params broadcast along quantized_dimension
            qd = self.quant.quantized_dimension
            bshape = [1] * self.data.ndim
            bshape[qd] = scale.size
            scale = scale.reshape(bshape)
            zp = zp.reshape(bshape)
        return (self.data.astype(np.float32) - zp) * scale
