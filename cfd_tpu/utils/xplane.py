"""Minimal XSpace/XPlane profile parser (no TensorFlow dependency).

``jax.profiler.trace`` writes its capture as a serialized ``XSpace``
protobuf (``*.xplane.pb``). The TensorBoard profile plugin is the usual
consumer, but the proto is simple enough to walk by hand, and doing so
gives the benchmark harnesses per-event device durations written by the
device runtime itself, without a host clock in the measurement.

The reference analyses its committed nvprof capture the same way — device
timeline, not host wall clock (/root/reference/perf-test/single-GPU/
PyCUDA/profile.nvprof, SURVEY.md §5).

Proto shape (tsl/profiler/protobuf/xplane.proto):

    XSpace:  planes = 1 (repeated XPlane)
    XPlane:  name = 2, lines = 3 (repeated XLine),
             event_metadata = 4 (map<int64, XEventMetadata>)
    XEventMetadata (map value, field 2): id = 1, name = 2
    XLine:   name = 2, events = 4 (repeated XEvent), display_name = 11
    XEvent:  metadata_id = 1, duration_ps = 3

Only those fields are read; everything else is skipped wire-format-
generically, so schema additions cannot break the parser.
"""

from __future__ import annotations

import glob
import os

__all__ = [
    "device_module_durations_ms",
    "parse_device_durations",
    "latest_xplane_file",
]

# GPU device planes are named "/device:GPU:<n>"; the default reads card 0.
DEVICE_PLANE = "/device:GPU:0"


def _varint(b: bytes, i: int):
    x = 0
    s = 0
    while True:
        v = b[i]
        i += 1
        x |= (v & 0x7F) << s
        if not v & 0x80:
            return x, i
        s += 7


def _fields(b: bytes):
    """Yield (field_number, wire_type, value) over one message's wire bytes."""
    i = 0
    n = len(b)
    while i < n:
        tag, i = _varint(b, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _varint(b, i)
        elif wt == 2:  # length-delimited
            ln, i = _varint(b, i)
            v = b[i : i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            v = b[i : i + 4]
            i += 4
        elif wt == 1:  # 64-bit
            v = b[i : i + 8]
            i += 8
        else:  # groups (3/4) do not occur in xplane protos
            raise ValueError(f"unsupported wire type {wt}")
        yield fn, wt, v


def parse_device_durations(
    path: str, *, plane: str = DEVICE_PLANE, line: str = "XLA Modules"
) -> dict:
    """Read one ``*.xplane.pb`` capture -> ``{event_name: [duration_ms, ...]}``.

    ``plane`` names the device plane (``/device:GPU:<n>``). ``line="XLA
    Modules"`` gives whole-executable durations (one event per dispatch of
    a jitted function); ``line="XLA Ops"`` gives per-fusion/custom-call
    durations within them; a stream line (``"Stream #<k>..."``) gives the
    kernels launched on that stream.
    """
    data = open(path, "rb").read()
    out: dict = {}
    for fn_, wt, v in _fields(data):
        if fn_ != 1 or wt != 2:  # XSpace.planes
            continue
        name = ""
        meta: dict = {}
        lines = []
        for f2, w2, v2 in _fields(v):
            if f2 == 2 and w2 == 2:
                name = v2.decode(errors="replace")
            elif f2 == 3 and w2 == 2:
                lines.append(v2)
            elif f2 == 4 and w2 == 2:  # event_metadata map entry
                mid = None
                mname = None
                for f3, w3, v3 in _fields(v2):
                    if f3 == 2 and w3 == 2:  # XEventMetadata
                        for f4, w4, v4 in _fields(v3):
                            if f4 == 1 and w4 == 0:
                                mid = v4
                            elif f4 == 2 and w4 == 2:
                                mname = v4.decode(errors="replace")
                if mid is not None:
                    meta[mid] = mname or str(mid)
        if name != plane:
            continue
        for ln in lines:
            lname = ""
            events = []
            for f3, w3, v3 in _fields(ln):
                if f3 == 2 and w3 == 2:
                    lname = v3.decode(errors="replace")
                elif f3 == 11 and w3 == 2:
                    lname = v3.decode(errors="replace") or lname
                elif f3 == 4 and w3 == 2:
                    mid = dur = None
                    for f4, w4, v4 in _fields(v3):
                        if f4 == 1 and w4 == 0:
                            mid = v4
                        elif f4 == 3 and w4 == 0:
                            dur = v4
                    if mid is not None and dur is not None:
                        events.append((mid, dur))
            if lname != line:
                continue
            for mid, dur_ps in events:
                out.setdefault(meta.get(mid, str(mid)), []).append(dur_ps / 1e9)
    return out


def latest_xplane_file(logdir: str) -> str | None:
    """Newest ``*.xplane.pb`` under a ``jax.profiler.trace`` logdir."""
    hits = glob.glob(
        os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb")
    ) or glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True)
    return max(hits, key=os.path.getmtime) if hits else None


def device_module_durations_ms(logdir: str, **kw) -> dict:
    """Durations from the newest capture under ``logdir`` (see
    :func:`parse_device_durations`); ``{}`` if no capture was written."""
    path = latest_xplane_file(logdir)
    return parse_device_durations(path, **kw) if path else {}
