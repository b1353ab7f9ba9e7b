"""`llmctl-torch health` — health checks and drift detection (the JAX
package's ``health check`` / ``health drift``).

``check`` runs ``metrics.health.HealthManager`` on the global ``--device``
(the card's memory occupancy on ``cuda``) once, or every ``--interval``
seconds for ``--monitor-duration`` seconds, printing a plain-text table or
(``--json``) the report's dict with the JAX command's keys; it exits 1
when the report is critical. ``drift`` compares metrics with a baseline
JSON and exits 1 past the tolerance.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description="System health.")
    sub = ap.add_subparsers(dest="sub", metavar="{check,drift}")
    c = sub.add_parser("check", help="Run health checks once or "
                                     "continuously.")
    c.add_argument("--monitor-duration", default=0.0, type=float,
                   help="Seconds to keep monitoring (0 = one-shot).")
    c.add_argument("--interval", default=5.0, type=float)
    c.add_argument("--json", dest="as_json", action="store_true",
                   default=False)
    d = sub.add_parser("drift", help="Compare current metrics to a "
                                     "baseline; exit 1 on drift.")
    d.add_argument("--baseline", dest="baseline_path", required=True,
                   help="Baseline metrics JSON ({metric: value}).")
    d.add_argument("--current", dest="current_path", default=None,
                   help="Current metrics JSON (default: re-measure the "
                        "host).")
    d.add_argument("--tolerance", default=10.0, type=float,
                   help="Allowed drift percent.")
    return ap


def run(args) -> int:
    if args.sub is None:          # `health` alone checks once
        args = argparse.Namespace(
            **vars(build_parser("llmctl-torch health").parse_args(["check"])),
            root=args.root)
    if args.sub == "check":
        return check(args.monitor_duration, args.interval, args.as_json,
                     args.root.device)
    return drift(args.baseline_path, args.current_path, args.tolerance)


def _display(report) -> None:
    rows = [(c.name, c.status.value,
             f"{c.value:.1f}" if c.value is not None else "-", c.message)
            for c in report.checks]
    head = ("Check", "Status", "Value", "Message")
    widths = [max(len(r[i]) for r in rows + [head]) for i in range(4)]
    print(f"Health: {report.status.value.upper()}")
    for r in [head] + rows:
        print("  " + "  ".join([r[0].ljust(widths[0]), r[1].ljust(widths[1]),
                                r[2].rjust(widths[2]), r[3]]))


def check(monitor_duration: float, interval: float, as_json: bool,
          device="cuda") -> int:
    """Run health checks once or continuously; 1 when critical."""
    from ...metrics.health import HealthManager

    mgr = HealthManager(interval=interval, device=device)
    deadline = time.monotonic() + monitor_duration
    while True:
        report = mgr.run_checks()
        if as_json:
            print(json.dumps(report.to_dict()), flush=True)
        else:
            _display(report)
        if time.monotonic() >= deadline:
            break
        time.sleep(interval)
    return 1 if report.status.value == "critical" else 0


def drift(baseline_path: str, current_path, tolerance: float) -> int:
    """Compare current metrics to a baseline; 1 on drift."""
    baseline = json.loads(Path(baseline_path).read_text())
    if current_path:
        current = json.loads(Path(current_path).read_text())
    else:
        from ...metrics.observability import MetricsCollector
        s = MetricsCollector().sample_once()
        current = {"cpu_percent": s.cpu_percent,
                   "memory_percent": s.mem_percent}

    drifted = []
    for metric, base_val in baseline.items():
        if metric not in current or not isinstance(base_val, (int, float)):
            continue
        cur = current[metric]
        pct = (abs(cur - base_val) / abs(base_val) * 100.0
               if base_val else (100.0 if cur else 0.0))
        status = "DRIFT" if pct > tolerance else "ok"
        print(f"{metric}: baseline={base_val:.3f} current={cur:.3f} "
              f"({pct:+.1f}%) {status}")
        if pct > tolerance:
            drifted.append(metric)
    if drifted:
        print(f"drift detected in: {', '.join(drifted)}")
        return 1
    print("no drift beyond tolerance")
    return 0
