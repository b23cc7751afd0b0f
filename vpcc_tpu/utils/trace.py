"""Tracing / profiling substrate (the PCCLogger + PCCChrono equivalent).

Behavioral reference: `PCCLogger` multi-file trace sinks
(source/lib/PccLibBitstreamCommon/include/PCCLogger.h:43-125 — one text sink
per trace type: codec, bitstream, picture/frame conformance traces),
`pcc::chrono::Stopwatch` wall/user timers (PCCCommon PCCChrono.h) and
`getPeakMemory` (PCCMemory.h:52).

Additions: `device_profile` wraps jax.profiler for Perfetto traces of
the device stages.
"""

from __future__ import annotations

import contextlib
import os
import resource
import time
from enum import Enum
from pathlib import Path
from typing import Dict, Optional


class TraceType(Enum):
    CODEC = "codec"
    PATCH = "patch"
    BITSTREAM = "bitstream"
    ATLAS = "atlas"
    TILE = "tile"
    PCFRAME = "pcframe"
    RECFRAME = "rec_pcframe"
    PICTURE = "picture"
    SEI = "sei"


class Logger:
    """Multi-sink text trace logger; disabled sinks are no-ops."""

    def __init__(self, prefix: Optional[str] = None, enabled: Optional[set] = None):
        self.prefix = prefix
        self.enabled = enabled or set()
        self._files: Dict[TraceType, object] = {}

    def enable(self, *types: TraceType) -> None:
        self.enabled.update(types)

    def trace(self, ttype: TraceType, fmt: str, *args) -> None:
        if ttype not in self.enabled or self.prefix is None:
            return
        f = self._files.get(ttype)
        if f is None:
            path = f"{self.prefix}_{ttype.value}_log.txt"
            f = open(path, "a")
            self._files[ttype] = f
        f.write(fmt % args if args else fmt)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


class Stopwatch:
    """Wall + process-CPU stopwatch (reference: PCCChrono.h
    StopwatchUserTime; printed at PccAppEncoder.cpp:1145-1148)."""

    def __init__(self):
        self.wall = 0.0
        self.user = 0.0
        self._t0 = None
        self._u0 = None

    def start(self):
        self._t0 = time.perf_counter()
        self._u0 = os.times()
        return self

    def stop(self):
        self.wall += time.perf_counter() - self._t0
        u = os.times()
        self.user += (u.user - self._u0.user) + (u.children_user - self._u0.children_user)
        return self

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()


def peak_memory_kb() -> int:
    """Peak RSS in KB (reference: getPeakMemory, PCCMemory.h:52)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


@contextlib.contextmanager
def device_profile(out_dir: str):
    """Capture a JAX/Perfetto device trace for the enclosed stage."""
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
