"""Command line of the PyTorch/CUDA port: `simon apply` on the port's engine.

    python -m open_simulator_tpu_torch.cli apply -f example/simon-config.yaml \\
        [--device cpu] [--output-file F] [--scheduler-config F] [--use-greed] \\
        [-i/--interactive] [--no-auto-plan]

Runs on CUDA unless `--device` says otherwise, and fails without a card.
When pods stay unscheduled and the config names a new node, the add-node
capacity search runs (engine/capacity.py) and the report shows the planned
cluster; `--interactive` runs the reference's add-node loop instead, and
`--no-auto-plan` reports the unscheduled pods. Exit code 0 when every pod
placed, 2 when some stayed unscheduled, 1 on an error, 3 when a simulation
or sweep outlived OSIM_CALL_DEADLINE_S seconds: the CLI then exits, which
ends the abandoned work with the process (the port has no CPU degrade).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="open_simulator_tpu_torch.cli")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("apply", help="simulate deploying applications")
    p.add_argument("-f", "--simon-config", required=True, help="path of simon config")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--output-file", default="", help="write the report to a file")
    p.add_argument("--scheduler-config", default="",
                   help="KubeSchedulerConfiguration YAML merged with simon's plugin set")
    p.add_argument("--use-greed", action="store_true",
                   help="order pods by descending dominant resource share first")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="reference-style interactive add-node loop")
    p.add_argument("--no-auto-plan", action="store_true",
                   help="report unscheduled pods instead of searching for nodes")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    from .api.config import SimonConfig
    from .durable.watchdog import DeadlineExceeded
    from .engine.apply import ApplyError, run_apply
    from .utils.tracing import init_logging

    init_logging()
    try:
        cfg = SimonConfig.load(args.simon_config)
        out = open(args.output_file, "w") if args.output_file else None
        try:
            outcome = run_apply(
                cfg, interactive=args.interactive, auto_plan=not args.no_auto_plan, out=out,
                scheduler_config=args.scheduler_config, use_greed=args.use_greed,
                device=args.device,
            )
        finally:
            if out is not None:
                out.close()
    except (ApplyError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except DeadlineExceeded as e:
        print(f"error: {e}; abandoned", file=sys.stderr)
        return 3
    return 0 if not outcome.result.unscheduled else 2


if __name__ == "__main__":
    sys.exit(main())
