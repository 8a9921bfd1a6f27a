"""Debugging facilities: the time-travel debugger."""

from .time_travel import FrameRecording, TimeTravelingDebugger, rec, record_p, tag, time_machine

__all__ = ["FrameRecording", "TimeTravelingDebugger", "rec", "record_p", "tag", "time_machine"]
