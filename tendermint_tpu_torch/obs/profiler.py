"""On-demand profiling hooks — device trace + sampled event-loop
profile, armed over RPC (`profile_start`/`profile_stop`).

A live node must be profilable without a redeploy: when anomalies show
up mid-run, the operator starts a bounded profile against the RUNNING
node, pulls the artifacts from `data/profiles/`, and keeps serving. Two
captures per session:

- **device trace**: a `torch.profiler.profile` over the device the
  capture was built for — `"cuda"` (the default) records CPU and CUDA
  activity, `"cpu"` CPU activity only. At stop the Chrome trace is
  exported into the session directory and summarised per kernel:
  launches, and the total and median of the kernel's device time, of
  the host call that launched it (`cudaLaunchKernel`) and of the queue
  gap from that call to the kernel's start, kernel and launch records
  paired by their CUPTI correlation id. A trace that cannot start
  (no CUDA, a torch build without CUPTI, another profiler already
  running) is a structured `{"enabled": false, "error": ...}` in the
  session record, never an exception out of the RPC — and a capture
  asked for CUDA never falls back to a CPU-only trace that would read
  as a device trace;
- **sampled event-loop profile**: a daemon thread samples the event
  loop thread's stack (`sys._current_frames()`) on a fixed interval
  and aggregates identical stacks — the event LOOP, not the device, is
  the binding resource past ~32 validators, and
  `tm_event_loop_lag_seconds` says THAT it's slow while this says
  WHERE. Written as JSON (stack -> sample count, hottest first) at stop.

One session at a time (a second start is a caller error, surfaced as a
structured RPC error by rpc/core). torch is imported only when a device
trace starts; no clock reads outside the session driver itself —
session ids come from a monotonic counter, not wall time.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time
from collections import Counter
from typing import Optional

# the host calls that launch a kernel, as the trace names them
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class ProfilerUnavailable(RuntimeError):
    """The requested capture cannot run (already active / not active /
    device profiler required but missing). rpc/core maps this to a
    structured JSON-RPC error."""


class _StackSampler(threading.Thread):
    """Samples one thread's Python stack on a fixed interval."""

    def __init__(self, target_thread_id: int, interval_s: float):
        super().__init__(name="obs/profile-sampler", daemon=True)
        self.target_thread_id = target_thread_id
        self.interval_s = interval_s
        self.samples = 0
        self.stacks: Counter = Counter()
        # NOT named _stop: Thread._stop is a real (private) CPython
        # method that join() calls — shadowing it with an Event breaks
        # every join with "'Event' object is not callable"
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(self.interval_s):
            frame = sys._current_frames().get(self.target_thread_id)
            if frame is None:
                continue
            stack = []
            depth = 0
            while frame is not None and depth < 64:
                code = frame.f_code
                stack.append(
                    f"{os.path.basename(code.co_filename)}:"
                    f"{frame.f_lineno}:{code.co_name}"
                )
                frame = frame.f_back
                depth += 1
            # innermost-first; key on the tuple so identical stacks fold
            self.stacks[tuple(stack)] += 1
            self.samples += 1

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=2.0)


def kernel_short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameter list: "void (anonymous
    namespace)::verify_table_kernel(unsigned char const*, ...)" ->
    "verify_table_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.strip()


def _stats(values: list) -> dict:
    return {
        "total": round(sum(values), 6),
        "median": round(statistics.median(values), 6) if values else None,
    }


def device_trace_summary(doc) -> dict:
    """Per-kernel figures from a Chrome trace torch.profiler exported:
    every kernel record (category "kernel") paired by its correlation id
    with the host call that launched it (category "cuda_runtime" or
    "cuda_driver", a *LaunchKernel* call). Milliseconds: `device` is the
    kernel's duration, `launch` the host call's, `queue` the kernel's
    start less the host call's start. Kernels sorted by device time,
    most first; `unpaired` counts kernel records whose launch call the
    trace lacks."""
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    calls: dict = {}
    kernels = []
    n_calls = 0
    other: dict = {}
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "kernel":
            kernels.append((ev, corr))
        elif cat in _LAUNCH_CATEGORIES and "LaunchKernel" in ev.get("name", ""):
            n_calls += 1
            # a runtime call outranks the driver call beneath it
            if corr is not None and (
                corr not in calls or cat == "cuda_runtime"
            ):
                calls[corr] = ev
        elif cat.startswith("gpu_"):
            row = other.setdefault(cat, {"events": 0, "ms": 0.0})
            row["events"] += 1
            row["ms"] = round(row["ms"] + float(ev.get("dur", 0)) / 1e3, 6)
    by_name: dict = {}
    unpaired = 0
    for ev, corr in kernels:
        row = by_name.setdefault(
            kernel_short_name(ev.get("name", "")),
            {"device": [], "launch": [], "queue": []},
        )
        row["device"].append(float(ev.get("dur", 0)) / 1e3)
        call = calls.get(corr)
        if call is None:
            unpaired += 1
            continue
        row["launch"].append(float(call.get("dur", 0)) / 1e3)
        row["queue"].append(
            (float(ev.get("ts", 0)) - float(call.get("ts", 0))) / 1e3
        )
    rows = [
        {
            "name": name,
            "launches": len(row["device"]),
            "paired": len(row["launch"]),
            "device_ms": _stats(row["device"]),
            "launch_ms": _stats(row["launch"]),
            "queue_ms": _stats(row["queue"]),
        }
        for name, row in by_name.items()
    ]
    rows.sort(key=lambda r: -r["device_ms"]["total"])
    return {
        "kernels": rows,
        "launch_calls": n_calls,
        "unpaired": unpaired,
        "other_gpu": other,
    }


class ProfileCapture:
    """One-at-a-time profiling sessions writing into `out_dir`
    (data/profiles under the node home). `device` names what the
    device trace records: "cuda" (CPU and CUDA activity) or "cpu" (CPU
    activity only). `start()` returns the session record; `stop()`
    finalizes it with artifact paths, the device trace's per-kernel
    summary and the loop profile's top stacks."""

    def __init__(
        self,
        out_dir: str,
        sample_interval_s: float = 0.01,
        logger=None,
        device: str = "cuda",
    ):
        self.out_dir = out_dir
        self.sample_interval_s = sample_interval_s
        self.logger = logger
        self.device = str(device)
        self._lock = threading.Lock()
        self._session: Optional[dict] = None
        self._sampler: Optional[_StackSampler] = None
        self._device_tracing = False
        self._trace = None
        self._next_id = 1

    @property
    def active(self) -> bool:
        return self._session is not None

    # --- session lifecycle -----------------------------------------------

    def start(self, label: str = "", device: bool = True) -> dict:
        """Arm a session. `device=False` skips the device trace (loop
        profile only). Raises ProfilerUnavailable when a session is
        already running."""
        with self._lock:
            if self._session is not None:
                raise ProfilerUnavailable(
                    f"profile session {self._session['id']!r} already "
                    "running; call profile_stop first"
                )
            sid = f"profile_{self._next_id:04d}"
            self._next_id += 1
            session_dir = os.path.join(self.out_dir, sid)
            os.makedirs(session_dir, exist_ok=True)
            device_state = {"enabled": False}
            if device:
                device_state = self._start_device_trace(session_dir)
            sampler = _StackSampler(
                threading.get_ident(), self.sample_interval_s
            )
            sampler.start()
            self._sampler = sampler
            self._session = {
                "id": sid,
                "label": label,
                "dir": session_dir,
                "t_start": time.monotonic(),
                "device_trace": device_state,
                "loop_sample_interval_s": self.sample_interval_s,
            }
            out = dict(self._session)
            out.pop("t_start")
            return out

    def stop(self) -> dict:
        """Disarm; returns the finalized session record with artifact
        paths. Raises ProfilerUnavailable when nothing is running."""
        with self._lock:
            session = self._session
            if session is None:
                raise ProfilerUnavailable(
                    "no profile session running; call profile_start first"
                )
            self._session = None
            sampler, self._sampler = self._sampler, None
        session["duration_s"] = round(
            time.monotonic() - session.pop("t_start"), 3
        )
        if self._device_tracing:
            session["device_trace"] = dict(
                session["device_trace"],
                **self._stop_device_trace(session["dir"]),
            )
        if sampler is not None:
            sampler.stop()
            session["loop_profile"] = self._write_loop_profile(
                session["dir"], sampler
            )
        return session

    # --- device trace (torch.profiler) ------------------------------------

    def _start_device_trace(self, session_dir: str) -> dict:
        kind = self.device.split(":", 1)[0]
        try:
            import torch
            from torch.profiler import (
                ProfilerActivity,
                profile,
                supported_activities,
            )

            activities = [ProfilerActivity.CPU]
            if kind == "cuda":
                if not torch.cuda.is_available():
                    raise ProfilerUnavailable(
                        "device trace on 'cuda' asked for, but "
                        "torch.cuda.is_available() is false"
                    )
                if ProfilerActivity.CUDA not in supported_activities():
                    raise ProfilerUnavailable(
                        "device trace on 'cuda' asked for, but this torch "
                        "build's profiler has no CUDA activity"
                    )
                activities.append(ProfilerActivity.CUDA)
            elif kind != "cpu":
                raise ProfilerUnavailable(
                    f"no device trace for device {self.device!r}"
                )
            trace = profile(
                activities=activities, record_shapes=False, with_stack=False
            )
            trace.start()
        except Exception as e:  # no CUDA, no CUPTI, a profiler running
            if self.logger is not None:
                self.logger.error(
                    "device trace unavailable", err=repr(e)
                )
            return {
                "enabled": False,
                "device": self.device,
                "error": repr(e)[:400],
            }
        self._trace = trace
        self._device_tracing = True
        return {
            "enabled": True,
            "dir": session_dir,
            "device": self.device,
            "activities": sorted(a.name for a in activities),
        }

    def _stop_device_trace(self, session_dir: str) -> dict:
        self._device_tracing = False
        trace, self._trace = self._trace, None
        path = os.path.join(session_dir, "device_trace.json")
        try:
            trace.stop()
            trace.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        except Exception as e:
            if self.logger is not None:
                self.logger.error(
                    "device trace stop failed", err=repr(e)
                )
            return {"stop_error": repr(e)[:400]}
        return {"path": path, **device_trace_summary(doc)}

    # --- loop profile -----------------------------------------------------

    @staticmethod
    def _write_loop_profile(session_dir: str, sampler: _StackSampler) -> dict:
        top = [
            {"count": count, "stack": list(stack)}
            for stack, count in sampler.stacks.most_common(64)
        ]
        doc = {
            "samples": sampler.samples,
            "interval_s": sampler.interval_s,
            "stacks": top,
        }
        path = os.path.join(session_dir, "loop_profile.json")
        try:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        except OSError:
            path = ""
        return {
            "samples": sampler.samples,
            "path": path,
            "top_stacks": top[:8],
        }
