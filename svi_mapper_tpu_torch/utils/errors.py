"""Typed errors raised at the host boundary (configuration, file IO,
dataset playback, run-level tracking failures). Per-landmark control flow
is masks, not exceptions."""

from __future__ import annotations


class SviMapperError(Exception):
    """Base class for all svi_mapper_tpu_torch errors."""


class ParameterError(SviMapperError, ValueError):
    """Bad calibration/configuration input (ref CExceptionParameter)."""


class InvalidFileError(SviMapperError, ValueError):
    """Corrupt or unsupported file (ref CExceptionInvalidFile)."""


class EndOfFileError(SviMapperError, EOFError):
    """Stream/dump exhausted mid-record (ref CExceptionEndOfFile)."""


class PoseOptimizationError(SviMapperError, RuntimeError):
    """Pose solve rejected at run level after every fallback
    (ref CExceptionPoseOptimization, CSolverStereoPosit.cpp:128-168).
    Inside the frame step the same condition is the ``posit_ok`` mask; this
    type is raised only by strict host wrappers."""


class TrackLostError(SviMapperError, RuntimeError):
    """Tracking lost: the active landmark set collapsed
    (ref lost-track detection at >75 % loss, CTrackerSV.cpp:338-349)."""


class DetectionFailedError(SviMapperError, RuntimeError):
    """Feature detection produced no usable points
    (ref CExceptionDetectionFailed)."""


class NoMatchFoundError(SviMapperError, RuntimeError):
    """Descriptor matching found nothing under the cutoff — host-side
    matching utilities only (ref CExceptionNoMatchFound; on the device this
    is a mask)."""


class ZeroDisparityError(SviMapperError, ValueError):
    """Disparity below the minimum — degenerate triangulation
    (ref CExceptionZeroDisparity, CTriangulator min-disparity 0.01 px)."""


class EpipolarLineError(SviMapperError, RuntimeError):
    """Epipolar geometry degenerate for a detection point
    (ref CExceptionEpipolarLine; on the device it is a sampled-window
    mask)."""
