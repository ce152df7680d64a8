"""Backend registry: the second-backend seam (reference:
band/backend_factory.h:195-203, registration at backend_factory.cc:10-33).

 * ``"torch"`` — the only built-in: per-(subgraph, worker) PyTorch
   programs whose int8 ops run the hand-written CUDA kernels on a card
   and their plain versions on the host (backend/executor.ModelExecutor).
 * A custom backend registers an executor class with the same duck
   interface (prepare_subgraph / execute / execute_batched / program /
   input_ids / output_ids / largest_subgraph_key / is_warm /
   max_warm_bucket) and is selected per worker via
   ``WorkerSpec.backend``.

The host custom-op path stays inside ModelExecutor: it is per-subgraph
(a subgraph with custom ops on a host worker), not a per-worker backend.

Counterpart: band_tpu/backend/factory.py, whose default is ``"xla"``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ..errors import ConfigError

_REGISTRY: Dict[str, Callable] = {}


def register_backend(name: str, creator: Callable) -> None:
    """Register an executor creator.  ``creator(model_id, graph,
    worker_id, device, exact=..., host=...)`` must return a
    ModelExecutor-compatible object."""
    _REGISTRY[name.lower()] = creator


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


def create_executor(name: str, *args, **kwargs):
    creator = _REGISTRY.get((name or "torch").lower())
    if creator is None:
        raise ConfigError(
            f"unknown backend {name!r}; available: {available_backends()}"
        )
    return creator(*args, **kwargs)


def _register_default() -> None:
    from .executor import ModelExecutor

    register_backend("torch", ModelExecutor)


_register_default()
