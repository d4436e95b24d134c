"""Offline fault-layer CLI (own copy of ``dstack_tpu.faults.__main__``).

``python -m dstack_tpu_torch.faults``            list registered injection points
``python -m dstack_tpu_torch.faults --validate PLAN``
                                           validate a plan (path, @path,
                                           inline JSON, or ``-`` for stdin)
                                           without installing it; exit 1
                                           with per-rule errors when invalid

``tests/test_torch_faults.py`` runs it in a subprocess, so the point
catalog and plan validator stay runnable on a bare image.
"""

import argparse
import json
import sys

from dstack_tpu_torch.faults import validate_plan
from dstack_tpu_torch.faults.catalog import POINTS


def _load(arg: str) -> dict:
    if arg == "-":
        return json.loads(sys.stdin.read())
    text = arg.strip()
    if text.startswith("@"):
        text = open(text[1:]).read()
    elif not text.lstrip().startswith("{"):
        text = open(text).read()  # bare path
    return json.loads(text)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dstack_tpu_torch.faults",
        description="List injection points / validate a DTPU_FAULT_PLAN.",
    )
    p.add_argument(
        "--validate",
        metavar="PLAN",
        help="plan to validate: a file path, @path, inline JSON, or '-'",
    )
    args = p.parse_args(argv)
    if args.validate is None:
        print(f"{len(POINTS)} registered injection points:\n")
        for name in sorted(POINTS):
            desc, ctx = POINTS[name]
            ctx_s = f"  [ctx: {', '.join(ctx)}]" if ctx else ""
            print(f"  {name}{ctx_s}")
            print(f"      {desc}")
        print(
            "\nActivate a plan via DTPU_FAULT_PLAN (inline JSON or @path); "
            "validate one with --validate."
        )
        return 0
    try:
        data = _load(args.validate)
    except (OSError, json.JSONDecodeError) as e:
        print(f"cannot load plan: {e}", file=sys.stderr)
        return 1
    errors = validate_plan(data)
    if errors:
        for e in errors:
            print(f"invalid: {e}", file=sys.stderr)
        return 1
    rules = data.get("rules", [])
    print(
        f"OK: {len(rules)} rule(s), seed={data.get('seed', 0)}; points: "
        + ", ".join(sorted({r["point"] for r in rules}))
    )
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # `python -m dstack_tpu_torch.faults | head` must not traceback
        sys.exit(0)
