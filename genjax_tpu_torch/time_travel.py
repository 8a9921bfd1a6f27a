"""Time-travel debugging: the public facade of ``debug/time_travel.py``.

Counterpart of ``genjax_tpu/time_travel.py``.
"""

from .debug.time_travel import FrameRecording, TimeTravelingDebugger, rec, tag, time_machine

__all__ = ["FrameRecording", "TimeTravelingDebugger", "rec", "tag", "time_machine"]
