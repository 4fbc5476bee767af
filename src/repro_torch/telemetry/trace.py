"""Chrome-trace (Perfetto / ``chrome://tracing``) export of a fleet run.

Converts a recorder's phase spans into the Trace Event Format's complete
(``"ph": "X"``) events — one track (tid) per fleet lane, engine-level
phases on tid 0 — plus instant events for the compile-accounting deltas,
so a whole co-simulated fleet epoch timeline opens directly in
``chrome://tracing`` or https://ui.perfetto.dev.

Timestamps are microseconds relative to the earliest span, as the format
expects; span metadata rides along in ``args`` for the inspector pane.
"""
from __future__ import annotations

import json
from typing import List

from repro_torch.telemetry.recorder import FleetRecorder
from repro_torch.telemetry.sinks import jsonable

__all__ = ["chrome_trace_events", "write_chrome_trace"]


def chrome_trace_events(recorder: FleetRecorder) -> List[dict]:
    """The recorder's spans + compile deltas as Trace Event Format dicts."""
    spans = recorder.spans
    t_base = min((sp.t0 for sp in spans), default=0.0)
    name = str(recorder.meta.get("scenario", "fleet"))
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": f"repro_torch co-sim: {name}"}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "engine"}},
    ]
    lanes = sorted({sp.meta["lane"] for sp in spans if "lane" in sp.meta})
    for lane in lanes:
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": int(lane) + 1,
                       "args": {"name": f"lane {lane}"}})
    for sp in spans:
        tid = int(sp.meta["lane"]) + 1 if "lane" in sp.meta else 0
        events.append({
            "name": sp.name, "ph": "X", "pid": 0, "tid": tid,
            "ts": 1e6 * (sp.t0 - t_base),
            "dur": 1e6 * max(sp.seconds, 0.0),
            "args": {k: v for k, v in sp.meta.items() if k != "lane"}})
    t_end = max((sp.t1 for sp in spans), default=t_base)
    for site, n in sorted(recorder.compile_delta().items()):
        events.append({"name": f"compile:{site} ×{n}", "ph": "i",
                       "pid": 0, "tid": 0, "s": "g",
                       "ts": 1e6 * (t_end - t_base),
                       "args": {"site": site, "count": int(n)}})
    return events


def write_chrome_trace(recorder: FleetRecorder, path: str) -> str:
    """Write the trace JSON to ``path`` and return the path."""
    doc = {"traceEvents": chrome_trace_events(recorder),
           "displayTimeUnit": "ms",
           "otherData": jsonable(dict(recorder.meta))}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return str(path)
