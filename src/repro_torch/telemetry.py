"""Telemetry for the port: spans and metrics fanning out to sinks.

A copy of the parts of the JAX package's ``repro.telemetry`` that the
serving engine, the trainer and their CLIs use — one flat event schema,
counters, gauges, histograms with exact nearest-rank p50/p99, the JSONL
and Chrome-trace sinks behind ``--metrics_jsonl`` / ``--trace``, the
:class:`Recorder`, the no-op ``NULL`` recorder and the predicted-vs-
measured :class:`DriftMonitor` behind the train CLI's ``--drift_report``
and ``summarize_events`` behind its ``--event_log``.  Spans enter
``torch.profiler.record_function`` so host spans line up with the device
kernels in a ``torch.profiler`` trace; ``device_time_in_spans`` reads a
profile that way.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import numbers
import os
import threading
import time
from typing import (Any, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import torch

# ---------------------------------------------------------------------------
# event schema
# ---------------------------------------------------------------------------

EVENT_KINDS = ("span", "counter", "gauge", "histogram", "event")
_REQUIRED: Dict[str, Tuple[str, ...]] = {
    "span": ("dur",), "counter": ("value",), "gauge": ("value",),
    "histogram": ("value",), "event": (),
}


def validate_event(ev: Any) -> List[str]:
    """Return the list of schema violations (empty = valid)."""
    if not isinstance(ev, dict):
        return [f"event is {type(ev).__name__}, not a dict"]
    errs: List[str] = []
    if not isinstance(ev.get("ts"), numbers.Real):
        errs.append("missing/non-numeric 'ts'")
    kind = ev.get("kind")
    if kind not in EVENT_KINDS:
        errs.append(f"'kind' {kind!r} not in {EVENT_KINDS}")
    name = ev.get("name")
    if not isinstance(name, str) or not name:
        errs.append("missing/empty 'name'")
    for field in _REQUIRED.get(kind, ()):
        if not isinstance(ev.get(field), numbers.Real):
            errs.append(f"span/metric field {field!r} missing or non-numeric")
    if kind == "span" and isinstance(ev.get("dur"), numbers.Real) \
            and ev["dur"] < 0:
        errs.append(f"negative span dur {ev['dur']}")
    attrs = ev.get("attrs")
    if attrs is not None and not isinstance(attrs, dict):
        errs.append("'attrs' must be a dict when present")
    return errs


def make_event(kind: str, name: str, ts: float, **fields: Any) -> Dict:
    """Build one schema-conforming event (validated at construction)."""
    ev = {"ts": float(ts), "kind": kind, "name": name, **fields}
    errs = validate_event(ev)
    if errs:
        raise ValueError(f"invalid telemetry event {ev!r}: {errs}")
    return ev


def summarize_events(events: Iterable[Dict]) -> Dict:
    """Aggregate a supervisor-style event list into the summary document
    the ``--event_log`` flag writes (the resilience tests read these exact
    keys)."""
    events = list(events)
    failures = [e for e in events if e.get("kind") == "failure"]
    return {
        "n_failures": len(failures),
        "total_lost_steps": sum(e.get("lost_steps") or 0 for e in failures),
        "total_recovery_s": sum(e.get("recovery_wall_s") or 0.0
                                for e in failures),
        "events": events,
    }


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile: sorted[ceil(q/100 * n) - 1]."""
    if not values:
        raise ValueError("percentile of empty sequence")
    s = sorted(values)
    if q <= 0:
        return s[0]
    rank = math.ceil(q / 100.0 * len(s))
    return s[min(rank, len(s)) - 1]


class Counter:
    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, delta: float = 1.0) -> float:
        with self._lock:
            self.value += delta
            return self.value

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, value: float) -> float:
        with self._lock:
            self.value = float(value)
            return self.value

    def snapshot(self) -> Dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Keeps the raw observations, so percentiles are exact (a serving
    run's windows are bounded; exactness beats a streaming sketch)."""

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1) -> None:
        value = float(value)
        with self._lock:
            self.values.extend([value] * n)
            self.sum += value * n

    def snapshot(self) -> Dict:
        with self._lock:
            out = {"type": "histogram", "count": len(self.values),
                   "sum": self.sum}
            if self.values:
                out["mean"] = self.sum / len(self.values)
                out["min"] = min(self.values)
                out["max"] = max(self.values)
                for q in (50, 90, 99):
                    out[f"p{q}"] = percentile(self.values, q)
            return out


class MetricsRegistry:
    """Named instruments, created on first use, snapshottable at once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, *args)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            items = list(self._instruments.items())
        return {name: inst.snapshot() for name, inst in sorted(items)}


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

def _jsonable(obj):
    """Last-resort coercion for numpy/torch scalars in event payloads."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError, RuntimeError):
            pass
    return str(obj)


class Sink:
    def emit(self, event: Dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """One JSON object per line, flushed per event."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "w")
        self._lock = threading.Lock()

    def emit(self, event: Dict) -> None:
        line = json.dumps(event, default=_jsonable)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class ChromeTraceSink(Sink):
    """Chrome-trace / Perfetto JSON, written on close: spans -> 'X' events,
    gauges/counters -> 'C', histograms/events -> 'i' (µs timestamps)."""

    def __init__(self, path: str, pid: int = 1,
                 process_name: str = "repro_torch"):
        self.path = path
        self.pid = pid
        self.process_name = process_name
        self._events: List[Dict] = []
        self._tids: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _tid(self, tid: Optional[int]) -> int:
        return self._tids.setdefault(tid or 0, len(self._tids))

    def emit(self, event: Dict) -> None:
        kind, name = event.get("kind"), event.get("name", "?")
        ts = float(event.get("ts", 0.0)) * 1e6
        with self._lock:
            if self._closed:
                return
            if kind == "span":
                ev = {"ph": "X", "name": name, "ts": ts,
                      "dur": float(event.get("dur", 0.0)) * 1e6,
                      "pid": self.pid, "tid": self._tid(event.get("tid"))}
                if event.get("attrs"):
                    ev["args"] = event["attrs"]
            elif kind in ("gauge", "counter"):
                ev = {"ph": "C", "name": name, "ts": ts, "pid": self.pid,
                      "tid": 0, "args": {"value": event.get("value", 0.0)}}
            else:
                ev = {"ph": "i", "name": name, "ts": ts, "pid": self.pid,
                      "tid": self._tid(event.get("tid")), "s": "t"}
                args = dict(event.get("attrs") or {})
                if "value" in event:
                    args["value"] = event["value"]
                if args:
                    ev["args"] = args
            self._events.append(ev)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            meta = [{"ph": "M", "name": "process_name", "pid": self.pid,
                     "tid": 0, "args": {"name": self.process_name}}]
            meta += [{"ph": "M", "name": "thread_name", "pid": self.pid,
                      "tid": tid, "args": {"name": f"host-{tid} ({ident})"}}
                     for ident, tid in sorted(self._tids.items(),
                                              key=lambda kv: kv[1])]
            doc = {"traceEvents": meta + self._events,
                   "displayTimeUnit": "ms"}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(doc, f, default=_jsonable)


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------

class _SpanState(threading.local):
    def __init__(self):
        self.stack: List[str] = []


class Recorder:
    """Emits schema events to sinks and aggregates into a registry.

    clock: monotonic-time source, injectable for deterministic tests;
    annotate: wrap spans in ``torch.profiler.record_function``.
    """

    def __init__(self, sinks: Sequence[Sink] = (), clock=time.monotonic,
                 annotate: bool = True):
        self.sinks: List[Sink] = list(sinks)
        self.clock = clock
        self.annotate = annotate
        self.metrics = MetricsRegistry()
        self._span_state = _SpanState()
        self.enabled = True

    def add_sink(self, sink: Sink) -> Sink:
        self.sinks.append(sink)
        return sink

    def _emit(self, event: Dict) -> None:
        for sink in self.sinks:
            sink.emit(event)

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Dict]:
        """Time a block; emits a span event even when the body raises.
        Yields a mutable dict whose entries land in the event's attrs."""
        if not self.enabled:
            yield {}
            return
        stack = self._span_state.stack
        depth = len(stack)
        parent = stack[-1] if stack else None
        stack.append(name)
        ann = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        live_attrs: Dict[str, Any] = dict(attrs)
        t0 = self.clock()
        try:
            with ann:
                yield live_attrs
        finally:
            dur = max(0.0, self.clock() - t0)
            stack.pop()
            ev = make_event("span", name, t0, dur=dur,
                            tid=threading.get_ident(), depth=depth)
            if parent is not None:
                ev["parent"] = parent
            if live_attrs:
                ev["attrs"] = live_attrs
            self._emit(ev)

    def counter(self, name: str, delta: float = 1.0, **attrs: Any) -> float:
        if not self.enabled:
            return 0.0
        total = self.metrics.counter(name).inc(delta)
        ev = make_event("counter", name, self.clock(), value=total,
                        delta=delta)
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)
        return total

    def gauge(self, name: str, value: float, **attrs: Any) -> None:
        if not self.enabled:
            return
        self.metrics.gauge(name).set(value)
        ev = make_event("gauge", name, self.clock(), value=float(value))
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)

    def observe(self, name: str, value: float, n: int = 1,
                **attrs: Any) -> None:
        if not self.enabled:
            return
        self.metrics.histogram(name).observe(value, n)
        ev = make_event("histogram", name, self.clock(), value=float(value))
        if n != 1:
            ev["n"] = n
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)


class _NullRecorder(Recorder):
    """A disabled recorder: every operation is a no-op, so instrumented
    call sites never branch on ``if telemetry is not None``."""

    def __init__(self):
        super().__init__(sinks=(), annotate=False)
        self.enabled = False

    def add_sink(self, sink: Sink) -> Sink:
        raise RuntimeError("cannot attach sinks to the null recorder; "
                           "construct a Recorder instead")


NULL = _NullRecorder()


# ---------------------------------------------------------------------------
# predicted-vs-measured drift (copied from repro/telemetry/drift.py)
# ---------------------------------------------------------------------------

# below this many seconds a measured term is noise, not signal
_MIN_MEASURED_S = 1e-9


class DriftMonitor:
    """Compares one predicted decomposition against measured windows.

    Given the cost model's per-term step-time decomposition for the
    resolved strategy (``StepReport.decomposition()``: seconds per step for
    ``step``/``compute``/``collective``/``bubble``/...), the monitor takes
    a measured decomposition each logging window, computes per-term
    ``predicted_over_measured`` ratios on the intersecting terms, emits them
    as ``drift/predicted_over_measured/<term>`` gauges and keeps the
    windows for :meth:`write`.  A ratio of 1.0 means the model nailed the
    term; > 1 it over-predicts, < 1 it under-predicts.  Terms whose
    measured value is ~0 get a ``null`` ratio rather than a fabricated
    number.
    """

    def __init__(self, predicted: Dict[str, float],
                 telemetry: Recorder = NULL,
                 meta: Optional[Dict] = None):
        self.predicted = {k: float(v) for k, v in predicted.items()}
        self.telemetry = telemetry
        self.meta = dict(meta or {})
        self.windows: List[Dict] = []

    def observe(self, measured: Dict[str, float],
                n_steps: int = 1) -> Dict:
        """Record one window of measured per-step times (seconds).

        ``measured`` maps term name -> mean seconds per step over the
        window.  Returns the window record, including the per-term
        ratio dict (``None`` where a term can't be compared).
        """
        measured = {k: float(v) for k, v in measured.items()}
        ratios: Dict[str, Optional[float]] = {}
        for term in sorted(set(self.predicted) & set(measured)):
            m = measured[term]
            if m <= _MIN_MEASURED_S:
                ratios[term] = None
                continue
            r = self.predicted[term] / m
            ratios[term] = r
            self.telemetry.gauge(
                f"drift/predicted_over_measured/{term}", r)
        window = {
            "window": len(self.windows),
            "n_steps": int(n_steps),
            "predicted": self.predicted,
            "measured": measured,
            "predicted_over_measured": ratios,
        }
        self.windows.append(window)
        return window

    def summary(self) -> Dict:
        """Mean ratio per term across all recorded windows."""
        per_term: Dict[str, List[float]] = {}
        for w in self.windows:
            for term, r in w["predicted_over_measured"].items():
                if r is not None:
                    per_term.setdefault(term, []).append(r)
        return {
            "meta": self.meta,
            "n_windows": len(self.windows),
            "predicted": self.predicted,
            "mean_predicted_over_measured": {
                t: sum(rs) / len(rs) for t, rs in sorted(per_term.items())
            },
        }

    def report(self) -> Dict:
        return {**self.summary(), "windows": self.windows}

    def write(self, path: str) -> Dict:
        """Write the full report JSON."""
        doc = self.report()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        return doc


# ---------------------------------------------------------------------------
# profiler reading
# ---------------------------------------------------------------------------

def device_time_in_spans(prof, span: str):
    """Device kernels of a ``torch.profiler`` run, by the host span they
    started in.  Each ``span`` must end after the kernels it launched have
    finished (a sync inside it), so a kernel belongs to the span its start
    falls in.  The device-side copies of the host spans (user annotations
    on the GPU timeline) are not kernels and are skipped.  -> (number of
    spans, their wall µs, device-busy µs inside them, µs by kernel name,
    launches by kernel name)."""
    from torch.autograd import DeviceType
    evs = prof.events()
    segs = sorted((e.time_range.start, e.time_range.end) for e in evs
                  if e.name == span and e.device_type == DeviceType.CPU)
    busy, by_name = 0.0, collections.Counter()
    counts = collections.Counter()
    for e in evs:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        s0 = e.time_range.start
        for t0, t1 in segs:
            if t0 <= s0 < t1:
                dur = min(e.time_range.end, t1) - s0
                busy += dur
                by_name[e.name] += dur
                counts[e.name] += 1
                break
    return len(segs), sum(t1 - t0 for t0, t1 in segs), busy, by_name, counts


def host_time_in_span(prof, span: str) -> float:
    """Host µs spent in every ``span`` of a ``torch.profiler`` run (its
    host-side events only)."""
    from torch.autograd import DeviceType
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.name == span and e.device_type == DeviceType.CPU)


def write_op_table(prof, path: str, device_times: bool) -> None:
    """``prof.key_averages()`` sorted by device time (when the profile has
    device times) and by host time, into the text file ``path``."""
    sorts = ["self_cpu_time_total"]
    if device_times:
        sorts.insert(0, "self_device_time_total")
    averages = prof.key_averages()
    with open(path, "w") as f:
        for sort in sorts:
            f.write(f"sorted by {sort}\n")
            f.write(averages.table(sort_by=sort, row_limit=40))
            f.write("\n\n")
