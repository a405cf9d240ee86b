"""Typed errors raised at the host boundary (configuration, run-level
tracking failures). Per-landmark control flow is masks, not exceptions."""

from __future__ import annotations


class SviMapperError(Exception):
    """Base class for all svi_mapper_tpu_torch errors."""


class ParameterError(SviMapperError, ValueError):
    """Bad calibration/configuration input (ref CExceptionParameter)."""


class TrackLostError(SviMapperError, RuntimeError):
    """Tracking lost: the active landmark set collapsed
    (ref lost-track detection at >75 % loss, CTrackerSV.cpp:338-349)."""
