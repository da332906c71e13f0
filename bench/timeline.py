"""The device timeline of a traced sub-window, from ``torch.profiler``.

The traced units run at the host's own speed under ``torch.profiler``
(CUPTI activity tracing of the device, and the host's operations), right
after the window in the same process.  The device's busy time is the
union of its kernels', copies' and fills' intervals; an operation's
device seconds are its kernels' own; a stretch in which the device ran
nothing is named by what the host was doing then: the innermost host
operation open at the middle of the stretch, under the benchmark's span
of the unit (``bench.<unit>``).  Each hand-written kernel's wrapper gets a
span of its own (``K5 ssd_scan_chunked``), which names its call on the
host; its device seconds are those of its kernels, by their names.

On the CPU (the tests) the host's operations stand in for the device's:
the outermost operations and wrapper spans are the "device" intervals.

The SSD scan's kernels (K5) end the process under CUPTI, with the CUDA
driver's modules loaded lazily or eagerly (``PERF.md`` §7).  A
configuration that runs them names ``"trace": "events"`` in its file and
gets ``EventTimeline``: CUDA events around each unit of work and each
call of a hand-written kernel's wrapper, and nothing around the
operations between them, so that the host runs at its own speed.  Its
busy time is the units' spans, gaps inside a unit included, and a
kernel's seconds are its wrapper's span.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

# the Kineto activities that are work on the device
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# a stretch without device work shorter than this is the launch of the
# next kernel, not a wait for the host
SHORT_GAP_NS = 20_000


class Timeline:
    """A context manager: while open, ``torch.profiler`` records the device
    and the host; every call of a wrapper named in ``wrappers``
    ({(module, attribute): name}) is a span of that name, and
    ``unit(name)`` is the span of one unit of work."""

    def __init__(self, device, wrappers: dict):
        self.cuda = torch.device(device).type == "cuda"
        self.wrappers = wrappers
        self.saved: list = []
        self.prof = None
        self.events = None

    def unit(self, name: str):
        return torch.profiler.record_function(f"bench.{name}")

    def _wrapped(self, name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    def __enter__(self):
        for (module, attr), name in self.wrappers.items():
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))
            setattr(module, attr, self._wrapped(name, fn))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        if self.cuda:
            # the tracer's first launch sets itself up: outside the window
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self._window = torch.profiler.record_function("bench.traced")
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self._window.__exit__(*exc)
        self.prof.__exit__(*exc)
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)
        self.saved.clear()
        self.events = _events(self.prof)
        return False

    def summary(self, top: int = 10) -> dict:
        """Busy seconds and the traced window's length, each device
        operation's seconds (``kernel_s``, and the ``top`` longest as
        ``device_ops``), and the idle stretches summed by what the host was
        doing (``idle_gaps``)."""
        host, dev = self.events
        window = [(s, e) for n, s, e in host if n == "bench.traced"]
        if not window:
            raise RuntimeError("the profiler recorded no traced window")
        w0, w1 = window[0]
        if not self.cuda:
            dev = _host_as_device(host, set(self.wrappers.values()))
        dev = sorted((n, max(s, w0), min(e, w1)) for n, s, e in dev
                     if e > w0 and s < w1)
        dev.sort(key=lambda t: t[1])
        by_name: dict = {}
        for name, s, e in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
        busy, gaps, end = 0, [], w0
        for _, s, e in dev:
            if s > end:
                gaps.append((end, s))
            busy += max(0, e - max(s, end))
            end = max(end, e)
        if w1 > end:
            gaps.append((end, w1))
        named: dict = {}
        where = _HostIndex(host)
        for a, b in gaps:
            key = (where.activity((a + b) // 2) if b - a >= SHORT_GAP_NS
                   else "between kernels launched back to back")
            named[key] = named.get(key, 0.0) + (b - a) * 1e-9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        waits = sorted(named.items(), key=lambda kv: -kv[1])
        return {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
                "kernel_s": by_name,
                "device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in waits[:top]]}


class EventTimeline:
    """``Timeline``'s interface from CUDA events (host clock on the CPU):
    a unit's span runs from an event recorded as it starts to one
    recorded as it ends, a wrapper's call likewise."""

    def __init__(self, device, wrappers: dict):
        self.cuda = torch.device(device).type == "cuda"
        self.wrappers = wrappers
        self.saved: list = []
        self.units: list = []
        self.calls: list = []
        self.opened = self.closed = None

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def _seconds(self, a, b):
        if self.cuda:
            return a.elapsed_time(b) * 1e-3
        return b - a

    @contextlib.contextmanager
    def unit(self, name: str):
        start = self._mark()
        yield
        self.units.append((f"bench.{name}", start, self._mark()))

    def _wrapped(self, name, fn):
        def call(*args, **kwargs):
            start = self._mark()
            out = fn(*args, **kwargs)
            self.calls.append((name, start, self._mark()))
            return out
        return call

    def __enter__(self):
        for (module, attr), name in self.wrappers.items():
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))
            setattr(module, attr, self._wrapped(name, fn))
        self.opened = self._mark()
        return self

    def __exit__(self, *exc):
        self.closed = self._mark()
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)
        self.saved.clear()
        if self.cuda:
            torch.cuda.synchronize()
        return False

    def summary(self, top: int = 10) -> dict:
        """As ``Timeline.summary``: the device busy from the start to the
        end of each unit, each wrapper's seconds, the rest of the units as
        one operation, and the stretches between units named by the unit
        that followed."""
        o = self.opened
        units = sorted(((n, self._seconds(o, s), self._seconds(o, e))
                        for n, s, e in self.units), key=lambda t: t[1])
        by_name: dict = {}
        for name, s, e in self.calls:
            by_name[name] = by_name.get(name, 0.0) + self._seconds(s, e)
        wrapped = sum(by_name.values())
        busy = sum(e - s for _, s, e in units)
        by_name["the units outside the wrapped kernels"] = busy - wrapped
        gaps: dict = {}
        end = 0.0
        for name, s, e in units:
            if s > end:
                key = f"before {name}"
                gaps[key] = gaps.get(key, 0.0) + s - end
            end = max(end, e)
        length = self._seconds(o, self.closed)
        if length > end:
            gaps["after the last unit"] = length - end
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        waits = sorted(gaps.items(), key=lambda kv: -kv[1])
        return {"busy_s": busy, "window_s": length, "kernel_s": by_name,
                "device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in waits[:top]]}


def make(kind: str, device, wrappers: dict):
    """The timeline a configuration's ``"trace"`` names: ``"profiler"``
    (the default) or ``"events"``."""
    return {"profiler": Timeline, "events": EventTimeline}[kind](
        device, wrappers)


def _ns(ev, what):
    """Start or end of a Kineto event in nanoseconds."""
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    if what == "start":
        return int(ev.start_us() * 1000)
    return int((ev.start_us() + ev.duration_us()) * 1000)


def _events(prof):
    """(host, device) lists of (name, start_ns, end_ns) of the profiler's
    events (``_split``)."""
    return _split(list(prof.profiler.kineto_results.events()))


def _split(raw):
    """The device's kernels, copies and fills, and the host's operations,
    annotations and runtime calls; the device's copies of the host's
    annotations are left out (by their Kineto activity where the event
    tells it, else by a name that the host's events carry too)."""
    def on_device(ev):
        return str(ev.device_type()).endswith("CUDA")
    host_names = {ev.name() for ev in raw if not on_device(ev)}
    host, dev = [], []
    for ev in raw:
        item = (_short(ev.name()), _ns(ev, "start"), _ns(ev, "end"))
        if not on_device(ev):
            host.append(item)
        elif hasattr(ev, "activity_type"):
            if ev.activity_type() in DEVICE_WORK:
                dev.append(item)
        elif ev.name() not in host_names:
            dev.append(item)
    return host, dev


def _short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        if cut in name and not name.startswith(cut):
            name = name.split(cut, 1)[0]
    return name


def _host_as_device(host, wrappers):
    """On the CPU: the wrappers' spans, and the outermost of the host's
    other operations that overlap none of them."""
    spans = sorted(ev for ev in host if ev[0] in wrappers)
    starts = sorted(s for _, s, _ in spans)
    ends = sorted(e for _, _, e in spans)

    def overlaps(s, e):
        # spans that start before e, less those that end by s
        return bisect.bisect_left(starts, e) - bisect.bisect_right(ends, s)
    others = [ev for ev in host if not ev[0].startswith("bench.")
              and ev[0] not in wrappers and not overlaps(ev[1], ev[2])]
    return spans + _outermost(others)


def _outermost(events):
    """The events that no other event encloses."""
    out, end = [], None
    for ev in sorted(events, key=lambda t: (t[1], -t[2])):
        if end is None or ev[1] >= end:
            out.append(ev)
            end = ev[2]
    return out


class _HostIndex:
    """What the host was doing at a moment: the benchmark's unit span open
    then and the innermost host operation open then."""

    def __init__(self, host):
        self.units = [ev for ev in host if ev[0].startswith("bench.")
                      and ev[0] != "bench.traced"]
        self.ops = sorted((ev for ev in host
                           if not ev[0].startswith("bench.")),
                          key=lambda ev: ev[1])
        self.starts = [ev[1] for ev in self.ops]

    def activity(self, t):
        unit = next((n for n, s, e in self.units if s <= t < e),
                    "between units")
        what = "no host operation"
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - 4096), -1):
            name, s, e = self.ops[j]
            if e > t:
                what = name
                break
        return f"{unit}: {what}"
