"""Operator CLI for the fleet layer.

::

    python -m repro_torch.fleet report  --store STORE [--reference ENV] ...
    python -m repro_torch.fleet stats   --store STORE
    python -m repro_torch.fleet diff    A B [--out FILE]
    python -m repro_torch.fleet merge   IN [IN ...] --out FILE [--policy P]
    python -m repro_torch.fleet promote BUNDLE --live PATH
    python -m repro_torch.fleet promote --rollback --live PATH

``report`` renders a smoother/train run's observed-vs-predicted table
(and, given a reference calibration, the drift audit — exit 1 with
``--assert-no-drift`` when anything drifted).  ``stats`` renders the
``metrics.json`` counter snapshot a production run persisted on
``save()`` (exchange/wire-byte/decision-cache counters, telemetry ring
occupancy — :mod:`repro_torch.obs.metrics`).  ``merge`` unifies N host
bundles (raw ``decisions.json`` files are auto-wrapped) under an
explicit conflict policy.  ``diff`` emits canonical JSON that
round-trips byte-identically.  ``promote`` stages a bundle as the live
engine file with a ``.prev`` backup for ``--rollback``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.fleet.bundle import (
    CONFLICT_POLICIES,
    diff_bundles,
    load_bundle,
    merge_bundles,
    promote,
    rollback,
)
from repro_torch.fleet.drift import (
    DEFAULT_MIN_SAMPLES,
    DEFAULT_THRESHOLD,
    DriftDetector,
)
from repro_torch.fleet.telemetry import TELEMETRY_FILENAME, ExchangeTelemetry


def _cmd_report(args: argparse.Namespace) -> int:
    from repro_torch.measure.decisions import DecisionCache
    from repro_torch.measure.production import DECISIONS_FILENAME
    from repro_torch.measure.store import ParamsStore

    store = Path(args.store)
    tel_path = Path(args.telemetry) if args.telemetry else (
        store / TELEMETRY_FILENAME
    )
    dec_path = Path(args.decisions) if args.decisions else (
        store / DECISIONS_FILENAME
    )
    telemetry = ExchangeTelemetry.load(tel_path)
    decisions = DecisionCache.load(dec_path)

    print(f"telemetry: {tel_path} ({len(telemetry)} keys)")
    print(telemetry.report())
    print()
    print(f"decisions: {dec_path} ({len(decisions)} rows)")
    print(decisions.report())

    if args.reference is None:
        if args.assert_no_drift:
            print(
                "error: --assert-no-drift needs --reference", file=sys.stderr
            )
            return 2
        return 0

    # drift audit: the live params this run priced with, vs the
    # reference calibration the operator trusts
    reference = ParamsStore.read_envelope(args.reference)
    if reference is None:
        print(
            f"error: unreadable reference envelope {args.reference}",
            file=sys.stderr,
        )
        return 2
    if args.params is not None:
        params = ParamsStore.read_envelope(args.params)
        if params is None:
            print(
                f"error: unreadable params envelope {args.params}",
                file=sys.stderr,
            )
            return 2
    else:
        params = reference  # self-audit: telemetry findings only
    detector = DriftDetector(args.threshold, args.min_samples)
    report = detector.audit(
        decisions, params, reference=reference, telemetry=telemetry,
        system=args.system,
    )
    print()
    print(report.summary())
    if args.drift_report:
        p = report.save(args.drift_report)
        print(f"drift report -> {p}")
    if args.assert_no_drift and report.drifted_count:
        print(
            f"DRIFT GATE FAILED: {report.drifted_count} drifted "
            f"decision(s): {', '.join(sorted(set(f.fingerprint for f in report.drifted)))}",
            file=sys.stderr,
        )
        return 1
    return 0


def _cmd_stats(args: argparse.Namespace) -> int:
    from repro_torch.measure.production import DECISIONS_FILENAME
    from repro_torch.obs.metrics import METRICS_FILENAME, MetricsRegistry

    store = Path(args.store)
    metrics_path = Path(args.metrics) if args.metrics else (
        store / METRICS_FILENAME
    )
    registry = MetricsRegistry.load(metrics_path)
    print(f"metrics: {metrics_path} ({len(registry)} series)")
    print(registry.report())

    dec_path = store / DECISIONS_FILENAME
    if dec_path.exists():
        try:
            bundle = load_bundle(dec_path)
        except Exception:
            bundle = None
        if bundle is not None:
            print()
            print(f"decisions: {bundle.summary()}")
    if args.json:
        print()
        print(json.dumps(registry.snapshot(), indent=2, sort_keys=True))
    return 0


def _cmd_diff(args: argparse.Namespace) -> int:
    d = diff_bundles(load_bundle(args.a), load_bundle(args.b))
    s = json.dumps(d, sort_keys=True, indent=2)
    if args.out:
        Path(args.out).write_text(s)
        print(f"diff -> {args.out}")
    else:
        print(s)
    n = len(d["added"]) + len(d["removed"]) + len(d["changed"])
    return 1 if (args.assert_same and n) else 0


def _cmd_merge(args: argparse.Namespace) -> int:
    bundles = [load_bundle(p) for p in args.inputs]
    merged = merge_bundles(
        bundles, policy=args.policy, generation=args.generation,
        host=args.host,
    )
    merged.save(args.out)
    print(f"{merged.summary()} -> {args.out}")
    return 0


def _cmd_promote(args: argparse.Namespace) -> int:
    if args.rollback:
        live = rollback(args.live)
        print(f"rolled back {live} from {live}.prev")
        return 0
    if args.bundle is None:
        print("error: promote needs a BUNDLE (or --rollback)",
              file=sys.stderr)
        return 2
    bundle = load_bundle(args.bundle)
    live, backup = promote(bundle, args.live)
    prev = f" (previous saved to {backup})" if backup else ""
    print(f"promoted {bundle.summary()} -> {live}{prev}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser(
        "report", help="observed-vs-predicted table + drift audit"
    )
    rp.add_argument(
        "--store", default=".",
        help="run store dir holding telemetry.json/decisions.json",
    )
    rp.add_argument("--telemetry", help="explicit telemetry file")
    rp.add_argument("--decisions", help="explicit decisions file")
    rp.add_argument(
        "--params", help="live params envelope the run priced with"
    )
    rp.add_argument(
        "--reference",
        help="trusted reference params envelope (enables the drift audit)",
    )
    rp.add_argument("--drift-report", help="write DriftReport JSON here")
    rp.add_argument(
        "--assert-no-drift", action="store_true",
        help="exit 1 when any decision drifted (CI gate)",
    )
    rp.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD)
    rp.add_argument("--min-samples", type=int, default=DEFAULT_MIN_SAMPLES)
    rp.add_argument("--system", default="", help="system label for the report")
    rp.set_defaults(fn=_cmd_report)

    sp = sub.add_parser(
        "stats", help="render a run's metrics.json counter snapshot"
    )
    sp.add_argument(
        "--store", default=".",
        help="run store dir holding metrics.json (and decisions.json)",
    )
    sp.add_argument("--metrics", help="explicit metrics file")
    sp.add_argument(
        "--json", action="store_true",
        help="also print the raw snapshot as JSON (machine-readable)",
    )
    sp.set_defaults(fn=_cmd_stats)

    dp = sub.add_parser("diff", help="canonical JSON diff of two bundles")
    dp.add_argument("a")
    dp.add_argument("b")
    dp.add_argument("--out", help="write the diff JSON here")
    dp.add_argument(
        "--assert-same", action="store_true",
        help="exit 1 when the bundles differ",
    )
    dp.set_defaults(fn=_cmd_diff)

    mp = sub.add_parser(
        "merge", help="deterministic merge of N bundles/decision files"
    )
    mp.add_argument("inputs", nargs="+")
    mp.add_argument("--out", required=True)
    mp.add_argument(
        "--policy", choices=CONFLICT_POLICIES, default="newest-generation"
    )
    mp.add_argument(
        "--generation", type=int,
        help="explicit output generation (default: max(input)+1)",
    )
    mp.add_argument("--host", default="", help="origin label for the merge")
    mp.set_defaults(fn=_cmd_merge)

    pp = sub.add_parser(
        "promote", help="install a bundle as the live decisions file"
    )
    pp.add_argument("bundle", nargs="?")
    pp.add_argument("--live", required=True, help="live decisions.json path")
    pp.add_argument(
        "--rollback", action="store_true",
        help="restore the .prev backup instead of promoting",
    )
    pp.set_defaults(fn=_cmd_promote)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
