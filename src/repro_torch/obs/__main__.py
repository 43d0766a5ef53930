"""Trace CLI.

::

    python -m repro_torch.obs summary  TRACE.json
    python -m repro_torch.obs validate TRACE.json

``summary`` renders the text flamechart: the span hierarchy with
observed phase wall time joined against the PerfModel predictions each
span recorded at trace time.  ``validate`` is the CI invariant check
(exit 1 on any violation): well-formed Chrome-trace JSON, every
``exchange`` span carrying a decision signature, and at most one
exchange per ``program_iteration`` (communication avoidance: exchanges
per application <= 1/s for a ``program/s=N`` decision).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs.export import load_chrome_trace, summary, validate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("summary", help="text flamechart, obs vs pred")
    sp.add_argument("trace", help="Chrome-trace JSON (--trace output)")
    vp = sub.add_parser("validate", help="CI invariant check (exit 1)")
    vp.add_argument("trace", help="Chrome-trace JSON (--trace output)")
    args = ap.parse_args(argv)

    try:
        trace = load_chrome_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"error: unreadable trace {args.trace}: {e}", file=sys.stderr)
        return 2
    if args.cmd == "summary":
        print(summary(trace))
        return 0
    errors = validate(trace)
    if errors:
        for e in errors:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    events = trace.get("traceEvents", ())
    n_ex = sum(1 for ev in events if ev.get("name") == "exchange")
    print(f"trace OK: {len(events)} events, {n_ex} exchange spans, "
          "signatures present, <=1 exchange per iteration")
    return 0


if __name__ == "__main__":
    sys.exit(main())
