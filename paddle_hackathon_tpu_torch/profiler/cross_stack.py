"""Cluster-level (multi-rank) timeline merging: the JAX package's
``profiler/cross_stack.py`` (pure Python over chrome-trace JSON).

Reference: ``tools/CrossStackProfiler/`` — ``ProfileFileReader`` /
``NetFileReader`` post-process per-rank profiler dumps into a single
cluster timeline (CspReporter merges per-trainer chrome traces under
distinct pids).

Each rank's chrome trace becomes one process row in a merged chrome
trace: pid = rank, thread rows preserved, optional time alignment on a
named sync marker (e.g. the per-step ``RecordEvent("step")``) so ranks
with skewed host clocks line up.

``stitch_fleet=True`` (CLI ``--stitch-fleet``) adds a serving-fleet
pass: events carrying a fleet trace context (``fleet_rid`` in their
args — the router's ``fleet.*`` spans emit it directly, and the
replicas' ``serving.request`` lifecycle spans carry both ``rid`` and
``fleet_rid``, which maps every other rid-keyed replica span) are
re-homed onto one synthesized "fleet requests" process with one thread
lane per fleet rid — router decision, each placement attempt, and the
replica's per-tick spans read as ONE swimlane per request, across
however many replicas served it.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import List, Optional

__all__ = ["merge_traces", "main"]


def _load(path: str) -> dict:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f)


def _rank_of(path: str) -> Optional[int]:
    m = re.search(r"(?:rank|worker|trainer)[_-]?(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else None


def _assign_ranks(ordered: List[str]) -> List[int]:
    """Deterministic pid per trace file.  Named files (rank0/worker1/...)
    keep their encoded rank; unnamed files take the smallest free pids in
    sorted-path order — a mixed named/unnamed merge must NOT silently
    renumber the named ranks (the old behavior: ANY collision between a
    named rank and an unnamed file's positional index threw away every
    name).  Only when the named files themselves collide (two files both
    claiming rank 1) is positional numbering the honest fallback."""
    ranks = [_rank_of(p) for p in ordered]
    named = [r for r in ranks if r is not None]
    if len(set(named)) != len(named):
        return list(range(len(ordered)))
    used = set(named)
    nxt = 0
    for i, r in enumerate(ranks):
        if r is None:
            while nxt in used:
                nxt += 1
            ranks[i] = nxt
            used.add(nxt)
    return ranks


def _flight_rows(path: str, pid: int) -> List[dict]:
    """Flight-recorder dump (``observability/flight.py``) as chrome
    instant events.  The dump's paired ``ts``/``perf_ns`` sample anchors
    its wall-clocked events onto the perf_counter timeline the span/
    counter events live on (valid for dumps from the traced host — the
    perf_counter epoch is per-boot)."""
    dump = _load(path)
    anchor_ns = dump.get("perf_ns")
    if anchor_ns is None:   # pre-anchor dump: cannot place honestly
        import warnings
        warnings.warn(f"flight dump {path} carries no perf_ns anchor; "
                      "skipping (cannot align wall clock to the trace)")
        return []
    wall_off_s = dump.get("ts", 0.0) - anchor_ns / 1e9  # wall = perf + off
    rows = [
        {"ph": "M", "name": "process_name", "pid": pid,
         "args": {"name": f"flight ({os.path.basename(path)})"}},
        {"ph": "M", "name": "process_sort_index", "pid": pid,
         "args": {"sort_index": pid}},
    ]
    for ev in dump.get("events", []):
        args = {k: v for k, v in ev.items() if k not in ("ts", "kind")}
        rows.append({"name": f"flight:{ev.get('kind', '?')}", "ph": "i",
                     "s": "p", "cat": "Flight", "pid": pid, "tid": 0,
                     "ts": (ev.get("ts", 0.0) - wall_off_s) * 1e6,
                     "args": args})
    return rows


def _stitch_fleet(merged: dict) -> dict:
    """Re-home fleet-request events onto per-``fleet_rid`` swimlanes.

    Pass 1 learns ``(pid, rid) -> fleet_rid`` from events whose args
    carry BOTH (the replica lifecycle spans; pid-scoped because engine
    rids are only unique within a process).  Pass 2 moves every event
    that resolves to a fleet rid — directly or via its rid — onto a
    synthesized process (one pid above the ranks) with ``tid =
    fleet_rid``, leaving unrelated events (ticks serving other
    requests, counters, flight rows without a rid) untouched on their
    original rank rows.  Mutates and returns ``merged``."""
    events = merged.get("traceEvents", [])
    rid_map = {}
    for e in events:
        a = e.get("args") or {}
        if a.get("fleet_rid") is not None and a.get("rid") is not None:
            rid_map[(e.get("pid"), a["rid"])] = a["fleet_rid"]
    fleet_pid = max((e["pid"] for e in events
                     if isinstance(e.get("pid"), int)), default=-1) + 1
    lanes = set()
    for e in events:
        if e.get("ph") == "M":
            continue
        a = e.get("args") or {}
        frid = a.get("fleet_rid")
        if frid is None:
            frid = rid_map.get((e.get("pid"), a.get("rid")))
            if frid is None:
                continue
        e["pid"] = fleet_pid
        e["tid"] = frid
        lanes.add(frid)
    if lanes:
        events.append({"ph": "M", "name": "process_name",
                       "pid": fleet_pid,
                       "args": {"name": "fleet requests (rid-stitched)"}})
        events.append({"ph": "M", "name": "process_sort_index",
                       "pid": fleet_pid,
                       "args": {"sort_index": fleet_pid}})
        for frid in sorted(lanes):
            events.append({"ph": "M", "name": "thread_name",
                           "pid": fleet_pid, "tid": frid,
                           "args": {"name": f"fleet_rid={frid}"}})
    return merged


def merge_traces(paths: List[str], align_marker: Optional[str] = None,
                 out_path: Optional[str] = None,
                 flight_paths: Optional[List[str]] = None,
                 stitch_fleet: bool = False) -> dict:
    """Merge per-rank chrome traces into one cluster timeline.

    ``align_marker``: event name whose first occurrence is treated as t=0
    on every rank (clock-skew compensation — the reference aligns on its
    profile step windows). Returns the merged trace dict; writes it to
    ``out_path`` when given.

    ``flight_paths``: flight-recorder dumps to overlay as instant-event
    rows (their own pids above the ranks) — a crash post-mortem lands on
    the same timeline as the spans leading up to it.  Incompatible with
    ``align_marker`` rebasing (the dumps carry no marker), so flight
    rows keep absolute perf-clock time.

    ``stitch_fleet``: run the fleet-request stitching pass (module
    docstring) after the merge — one swimlane per ``fleet_rid``
    spanning router spans and every replica's share of the request.
    """
    if align_marker and flight_paths:
        raise ValueError(
            "align_marker rebases every rank to its marker's t=0, but "
            "flight rows keep absolute perf-clock time (the dumps carry "
            "no marker) — the overlay would land far off the timeline; "
            "pass one or the other")
    merged = {"traceEvents": [], "displayTimeUnit": "ms"}
    ordered = sorted(paths)
    ranks = _assign_ranks(ordered)
    for idx, path in enumerate(ordered):
        rank = ranks[idx]
        trace = _load(path)
        if isinstance(trace, list):   # chrome "JSON Array Format"
            events = trace
        else:
            events = trace.get("traceEvents", [])
        t0 = 0.0
        if align_marker is not None:
            # span events only: a counter series ("ph":"C") that happens
            # to share the marker's name must not skew the alignment
            starts = [e["ts"] for e in events
                      if e.get("name") == align_marker and "ts" in e
                      and e.get("ph") not in ("C", "M")]
            if starts:
                t0 = min(starts)
            else:
                # marker missing on this rank: rebase on its earliest event
                # (keeping absolute time would skew it against the aligned
                # ranks far worse than approximate alignment)
                import warnings
                all_ts = [e["ts"] for e in events
                          if e.get("ph") != "M" and "ts" in e]
                t0 = min(all_ts) if all_ts else 0.0
                warnings.warn(
                    f"align marker {align_marker!r} not found in {path}; "
                    "falling back to the rank's earliest event")
        merged["traceEvents"].append({
            "ph": "M", "name": "process_name", "pid": rank,
            "args": {"name": f"rank {rank} "
                             f"({os.path.basename(path).split('_step')[0]})"},
        })
        merged["traceEvents"].append({
            "ph": "M", "name": "process_sort_index", "pid": rank,
            "args": {"sort_index": rank},
        })
        for e in events:
            if e.get("ph") == "M" and e.get("name") in (
                    "process_name", "process_sort_index"):
                continue  # replaced by the synthesized rank rows above
            e = dict(e)
            e["pid"] = rank
            if e.get("ph") != "M" and "ts" in e:
                e["ts"] = e["ts"] - t0
            merged["traceEvents"].append(e)
    if flight_paths:
        next_pid = (max(ranks) + 1) if ranks else 0
        for j, fp in enumerate(sorted(flight_paths)):
            merged["traceEvents"].extend(_flight_rows(fp, next_pid + j))
    if stitch_fleet:
        _stitch_fleet(merged)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Merge per-rank profiler chrome traces into one "
                    "cluster timeline (ref tools/CrossStackProfiler)")
    ap.add_argument("trace_dir", help="directory of per-rank *.json traces")
    ap.add_argument("-o", "--out", default="cluster_trace.json")
    ap.add_argument("--align", default=None,
                    help="event name used as per-rank t=0 (clock-skew fix)")
    ap.add_argument("--flight", nargs="*", default=None,
                    help="flight-recorder dump(s) to overlay as instant "
                         "events (incompatible with --align)")
    ap.add_argument("--stitch-fleet", action="store_true",
                    help="re-home fleet-request events (fleet_rid/rid "
                         "args) onto one swimlane per fleet request")
    args = ap.parse_args(argv)
    if args.align and args.flight:
        raise SystemExit("--flight rows keep absolute perf-clock time and "
                         "cannot be rebased by --align; pick one")
    paths = sorted(glob.glob(os.path.join(args.trace_dir, "*.json")) +
                   glob.glob(os.path.join(args.trace_dir, "*.json.gz")))
    if not paths:
        raise SystemExit(f"no traces found under {args.trace_dir}")
    merge_traces(paths, align_marker=args.align, out_path=args.out,
                 flight_paths=args.flight, stitch_fleet=args.stitch_fleet)
    print(f"merged {len(paths)} rank traces -> {args.out}")


if __name__ == "__main__":
    main()
