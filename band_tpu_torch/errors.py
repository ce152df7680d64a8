"""Status/error types.

The reference threads absl::Status through every layer; here we raise
typed exceptions at API boundaries and return ``JobStatus`` on the
request path (reference: band/engine.cc:593-595 surfaces SLO drops as
DeadlineExceeded).
"""

from __future__ import annotations


class BandError(Exception):
    """Base class for all band-tpu errors."""


class ConfigError(BandError):
    """Invalid runtime or benchmark configuration."""


class ModelError(BandError):
    """Model file cannot be parsed or is unsupported."""


class LoweringError(ModelError):
    """An op in the model graph has no lowering for the target worker."""


class ExecutionError(BandError):
    """A compiled subgraph failed to execute."""


class DeadlineExceeded(BandError):
    """Request dropped because its SLO could not be met."""


class NotFound(BandError):
    """Unknown model / worker / job id."""
