"""The measured window and, in a traced run, the profiled slice of it.

A driver starts the window, calls ``tick()`` after each unit of work (a
train step, a request, a fit step) and closes it.  The window lasts the
given seconds; its rate is the work of all its units over all its time.
With ``trace`` the profiler records ``slice_units`` units from the first
tick after a quarter of the window, each end after a synchronise, so the
trace file holds a steady slice and stays small; it is written to the
run's temporary directory, read and deleted.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional

import torch

from . import trace_reader


class Window:
    def __init__(self, seconds: float, device: torch.device, trace: bool = False, slice_units: int = 1):
        self.seconds = float(seconds)
        self.device = device
        self.trace = trace
        self.slice_units = int(slice_units)
        self.units = 0
        self.elapsed = 0.0
        self.t0: Optional[float] = None
        self.slice: Optional[trace_reader.Slice] = None
        self.slice_count = 0
        self._prof = None
        self._span = None
        self._first = 0
        self._opened = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.t0 = time.perf_counter()

    def done(self) -> bool:
        """The window's seconds have passed, and no profiled slice is open
        (a traced run goes on until its slice has its units)."""
        return time.perf_counter() - self.t0 >= self.seconds and self._prof is None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that its first
        start (CUPTI's, seconds on the card) is not paid in the window."""
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            with profile(activities=activities):
                torch.zeros(1, device=self.device).add_(1)
            self._sync()

    def tick(self) -> None:
        self.units += 1
        if not self.trace or self.slice is not None:
            return
        if self._prof is None:
            if time.perf_counter() - self.t0 >= 0.25 * self.seconds:
                self._open()
        elif self.units - self._first >= self.slice_units:
            self._shut()

    def close(self) -> None:
        self._sync()
        self.elapsed = time.perf_counter() - self.t0
        if self._prof is not None and self.slice is None:
            self._shut()

    def _open(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=activities)
        self._prof.start()
        self._span = record_function(trace_reader.SLICE)
        self._span.__enter__()
        self._first = self.units
        self._opened = time.perf_counter()

    def _shut(self) -> None:
        self._sync()
        host_s = time.perf_counter() - self._opened
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.slice_count = self.units - self._first
        fd, path = tempfile.mkstemp(suffix=".json", prefix="grinbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.slice = trace_reader.read(path, host_s)
        finally:
            os.unlink(path)
        self._prof = None
