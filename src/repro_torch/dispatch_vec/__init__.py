"""Vectorized batch-dispatch plane (see ``dispatch_vec.core``) plus the
device-resident score mirror (``dispatch_vec.device_mirror``)."""

from .core import VectorizedDispatcher
from .device_mirror import DeviceScoreMirror, MirrorStats

__all__ = ["VectorizedDispatcher", "DeviceScoreMirror", "MirrorStats"]
