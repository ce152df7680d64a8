"""Per-model input/output staging rings.

Decouples caller tensors from in-flight jobs: a request allocates a
handle, copies its tensors into the slot, and the job carries only the
handle (reference: band/tensor_ring_buffer.h:34-66, slot = handle %
size, validity window check tensor_ring_buffer.cc:58-69)."""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence

import numpy as np

from ..errors import NotFound
from ..ir.graph import TensorDef


class TensorRingBuffer:
    def __init__(self, tensor_defs: Sequence[TensorDef], size: int = 128):
        self._defs = list(tensor_defs)
        self._size = size
        self._head = 0
        self._lock = threading.Lock()
        self._slots: List[Dict[int, np.ndarray]] = [
            {
                td.index: np.zeros([max(s, 1) for s in td.shape], td.dtype)
                for td in self._defs
            }
            for _ in range(size)
        ]

    @property
    def tensor_ids(self) -> List[int]:
        return [td.index for td in self._defs]

    def alloc(self) -> int:
        """Returns a monotonically increasing handle."""
        with self._lock:
            handle = self._head
            self._head += 1
            return handle

    def _check(self, handle: int) -> None:
        if handle < 0 or handle >= self._head or handle < self._head - self._size:
            raise NotFound(f"ring handle {handle} out of validity window")

    def put(self, handle: int, tensors: Dict[int, np.ndarray]) -> None:
        # the copy stays under the lock (as the reference's ring does,
        # tensor_ring_buffer.cc): a handle wrapping out of the validity
        # window mid-copy would otherwise scribble over the slot its
        # successor now owns
        with self._lock:
            self._check(handle)
            slot = self._slots[handle % self._size]
            for tid, arr in tensors.items():
                np.copyto(slot[tid], np.asarray(arr).reshape(slot[tid].shape))

    def get(self, handle: int) -> Dict[int, np.ndarray]:
        with self._lock:
            self._check(handle)
            slot = self._slots[handle % self._size]
            return {tid: arr.copy() for tid, arr in slot.items()}

    def view(self, handle: int) -> Dict[int, np.ndarray]:
        """Zero-copy view of the slot (worker-side read)."""
        with self._lock:
            self._check(handle)
            return self._slots[handle % self._size]

    def is_valid(self, handle: int) -> bool:
        with self._lock:
            return 0 <= handle < self._head and handle >= self._head - self._size
