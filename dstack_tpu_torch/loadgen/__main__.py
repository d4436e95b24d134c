"""``python -m dstack_tpu_torch.loadgen`` — compile, soak, report (the
port's copy of ``python -m dstack_tpu.loadgen``, with its flags and
``--device``).

Default run: compile the stock workload for ``--duration`` seconds at
``--rate`` rps from ``--seed``, stand up ``--replicas`` real replicas
of the port's server on the card (``--device cpu``: on the CPU; no card
and no ``--device cpu`` raises) behind the real router with QoS on,
fire the open-loop schedule with the mid-soak drain flip + replica
kill enabled, and write ``build/SOAK_r01.json``. Two invocations with the same seed produce
byte-identical event schedules (the artifact's ``schedule_digest``
proves it; ``--schedule-only`` dumps the JSONL itself for a direct
diff).
"""

import argparse
import json
import os
import sys

from dstack_tpu_torch.loadgen.schedule import compile_schedule
from dstack_tpu_torch.loadgen.spec import default_spec, load_spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dstack_tpu_torch.loadgen",
        description="deterministic open-loop traffic-replay soak "
                    "(goodput under SLO; docs/guides/serving.md §11)",
    )
    p.add_argument("--seed", type=int, default=0,
                   help="workload seed: the schedule is a pure function "
                        "of (spec, seed)")
    p.add_argument("--duration", type=float, default=75.0,
                   help="soak length in seconds (default 75)")
    p.add_argument("--rate", type=float, default=3.0,
                   help="mean open-loop request rate (requests/s)")
    p.add_argument("--spec", default=None,
                   help="workload spec: inline JSON or @/path.json "
                        "(default: the stock interactive/standard/batch "
                        "mix at --duration/--rate)")
    p.add_argument("--replicas", type=int, default=2,
                   help="in-process replicas behind the router (>= 2)")
    p.add_argument("--model", default="llama-tiny")
    p.add_argument("--qos-rps", type=float, default=2.0,
                   help="per-tenant QoS bucket rate at each serve edge")
    p.add_argument("--qos-burst", type=float, default=6.0)
    p.add_argument("--no-chaos", action="store_true",
                   help="skip the mid-soak drain flip and replica kill")
    p.add_argument("--scale-up", action="store_true",
                   help="mid-soak, boot a COLD extra replica under the "
                        "boot recorder and join it to the pool; the "
                        "artifact gains a `boot` block decomposing its "
                        "time-to-first-served-token (BOOT_rNN baseline)")
    p.add_argument("--scale-up-frac", type=float, default=0.45,
                   help="when to spawn the cold replica (fraction of "
                        "duration)")
    p.add_argument("--kill-frac", type=float, default=0.60,
                   help="when to kill a replica (fraction of duration)")
    p.add_argument("--drain-frac", type=float, nargs=2,
                   default=(0.25, 0.40), metavar=("START", "END"),
                   help="DRAINING window for one replica (fractions)")
    p.add_argument("--output", default=os.path.join("build", "SOAK_r01.json"),
                   help="artifact path ('' = print only)")
    p.add_argument("--schedule-only", action="store_true",
                   help="compile and print the event schedule JSONL, "
                        "run nothing (determinism check: diff two runs)")
    p.add_argument("--validate-spec", action="store_true",
                   help="validate --spec offline and exit")
    p.add_argument("--device", default="cuda",
                   help="the replicas' device: cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.validate_spec:
        from dstack_tpu_torch.loadgen.spec import validate_spec

        raw = args.spec or "{}"
        data = (
            json.load(open(raw[1:]))
            if raw.startswith("@")
            else json.loads(raw)
        )
        errors = validate_spec(data)
        for e in errors:
            print(f"error: {e}", file=sys.stderr)
        print("spec ok" if not errors else f"{len(errors)} problem(s)")
        return 1 if errors else 0

    spec = (
        load_spec(args.spec)
        if args.spec
        else default_spec(duration_s=args.duration, rate_rps=args.rate)
    )
    schedule = compile_schedule(spec, args.seed)
    if args.schedule_only:
        sys.stdout.write(schedule.to_jsonl())
        print(
            f"# events={len(schedule.events)} seed={args.seed} "
            f"digest={schedule.digest()}",
            file=sys.stderr,
        )
        return 0

    # the soak runtime (torch + aiohttp) loads only past this point —
    # schedule compilation and validation stay import-light
    from dstack_tpu_torch.loadgen.soak import SoakConfig, run_soak

    cfg = SoakConfig(
        replicas=args.replicas,
        model=args.model,
        qos_rps=args.qos_rps,
        qos_burst=args.qos_burst,
        chaos=not args.no_chaos,
        scale_up=args.scale_up,
        scale_up_frac=args.scale_up_frac,
        drain_start_frac=args.drain_frac[0],
        drain_end_frac=args.drain_frac[1],
        kill_frac=args.kill_frac,
        output=args.output or None,
        device=args.device,
    )
    result = run_soak(schedule, cfg)
    print(json.dumps({
        k: result[k]
        for k in (
            "metric", "value", "unit", "seed", "schedule_digest",
            "events", "duration_s", "replicas", "backend", "note",
            "failures", "client_5xx", "router",
        )
    } | {k: result[k] for k in ("device", "power_limit") if k in result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
