"""Sharding policy of subgraph programs over a device mesh.

band_tpu's policy (band_tpu/parallel/sharding.py), spec for spec: conv
kernels (HWIO) shard output channels on the "tp" axis, depthwise kernels
([kh, kw, 1, C*m]) likewise, FC weights on their second axis, per-channel
bias and requant vectors of 8 or more entries on "tp"; what does not
divide by the axis size is replicated, and activations flow unsharded
(the batch is split on "dp" by the caller).  A spec is a tuple of axis
names and None, one per array axis (``()`` = replicated), as a
PartitionSpec reads.

band_tpu hands the specs to GSPMD, which keeps every partitioning
correct.  The port slices by hand, op by op (parallel/mesh.py), so the
specs here are a report, the one band_tpu would make; what the mesh
actually splits is every int8 conv-family op whose output channels
divide by tp, with all of its per-output-channel params
(ops/lowerings.py ``output_channels``, ``shard_params``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

Spec = Tuple[Optional[str], ...]


def _param_spec(name: str, arr: np.ndarray, tp_axis: Optional[str]) -> Spec:
    if tp_axis is None:
        return ()
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "w" and arr.ndim == 4:
        # HWIO conv kernel -> shard O; depthwise [kh, kw, 1, oc] likewise
        return (None, None, None, tp_axis)
    if leaf == "w" and arr.ndim == 2:
        # FC weights [in, out] (quant) or [out, in] (float)
        return (None, tp_axis)
    if leaf in ("bias", "qm", "shift", "mult") and arr.ndim == 1:
        if arr.shape[0] >= 8:  # don't shard scalars / tiny vectors
            return (tp_axis,)
    return ()


def param_shardings(prog, mesh, tp_axis: Optional[str] = "tp"
                    ) -> Dict[str, Spec]:
    """The spec of every param of ``prog`` on ``mesh``.  Channel dims not
    divisible by the axis size fall back to replication."""
    if tp_axis not in mesh.axis_names:
        tp_axis = None  # no tensor-parallel axis: replicate everything
    tp_size = mesh.shape[tp_axis] if tp_axis is not None else 1
    out = {}
    for name, arr in prog.params.items():
        arr = np.asarray(arr)
        spec = _param_spec(name, arr, tp_axis)
        dims = [d for d, ax in enumerate(spec) if ax is not None]
        ok = all(arr.shape[d] % tp_size == 0 for d in dims)
        out[name] = spec if ok else ()
    return out
