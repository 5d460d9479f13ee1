"""skylark_warmup: build / inspect / verify warmup packs, and probe a boot.

The deployment half of a fleet's boot from a warmup pack
(:mod:`libskylark_tpu_torch.engine.warmup`):

``build``
    Take explicit ``--spec`` JSON bucket specs, capture every (bucket,
    capacity) flush, and write the pack (capture records + ``pack.json``
    manifest) into ``--pack``. Without ``--spec`` the reference selects
    the top-N buckets from tune's plan cache, which the port has not yet
    (ROADMAP A6): the command then exits 2.
``inspect``
    Print the manifest summary and whether this host's runtime would
    accept the pack (compat probe + plan-fingerprint check).
``verify``
    Load the pack into this process (capture every entry) and report
    the loader's counts: a booted replica sees ``loaded == entries``,
    with the captures counted as ``aot_loads``, none as compiles.
``boot-probe``
    Boot a fresh serving process from the pack (or cold, ``--no-load``),
    serve every packed bucket's canonical cohort, and print one
    ``BOOT_PROBE {json}`` line: engine counters, bit-equality with the
    builder, time to first result.

Examples::

    python -m libskylark_tpu_torch.cli.skylark_warmup build --pack pack \\
        --spec '{"endpoint": "sketch_apply", "family": "JLT", "n": 8192, \\
        "m": 2048, "s_dim": 1024, "rowwise": true, "capacities": [1, 8]}'
    python -m libskylark_tpu_torch.cli.skylark_warmup inspect --pack pack
    python -m libskylark_tpu_torch.cli.skylark_warmup verify --pack pack
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="skylark_warmup",
        description="Warmup packs: the serve buckets a fresh process "
                    "captures before traffic")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="capture the buckets and write a pack")
    b.add_argument("--pack", required=True,
                   help="pack directory (created if missing)")
    b.add_argument("--top", type=int, default=8,
                   help="top-N buckets from tune's plan cache (not ported "
                        "yet; ignored when --spec is given)")
    b.add_argument("--stats", default=None,
                   help="serve-stats JSON ranking hot capacity classes "
                        "for the plan-cache selection")
    b.add_argument("--spec", action="append", default=[],
                   help="explicit bucket spec as JSON (repeatable); see "
                        "engine.warmup.BucketSpec")
    b.add_argument("--pad-floor", type=int, default=None)
    b.add_argument("--device", default=None,
                   help="where the buckets are captured (default: the "
                        "package default, cuda)")

    for name, hlp in (("inspect", "manifest summary + compat probe"),
                      ("verify", "load the pack into this process")):
        s = sub.add_parser(name, help=hlp)
        s.add_argument("--pack", required=True)

    bp = sub.add_parser(
        "boot-probe",
        help="boot a fresh serving process from the pack (or cold with "
             "--no-load), serve every packed bucket's canonical cohort, "
             "and report captures, loads, bit-equality and time to first "
             "result")
    bp.add_argument("--pack", required=True)
    bp.add_argument("--no-load", action="store_true",
                    help="cold side of the A/B: serve the same cohorts "
                         "without loading the pack")
    return p


def _cmd_build(args) -> int:
    from libskylark_tpu_torch.base import errors
    from libskylark_tpu_torch.engine import warmup

    if args.spec:
        specs = [warmup.BucketSpec.from_dict(json.loads(s))
                 for s in args.spec]
    else:
        try:
            specs = warmup.select_top_buckets(args.top)
        except errors.NotImplementedYetError as e:
            print(f"error: {e}; pass explicit --spec JSON", file=sys.stderr)
            return 2
    manifest = warmup.build_pack(args.pack, specs, pad_floor=args.pad_floor,
                                 device=args.device)
    missing = [e["digest"] for e in manifest["entries"]
               if e.get("artifact_missing")]
    print(json.dumps({
        "pack": args.pack,
        "entries": len(manifest["entries"]),
        "uncaptured": manifest["uncaptured"],
        "plan_fingerprint": manifest["plan_fingerprint"],
        "compat": manifest["compat"],
        "artifact_missing": missing,
    }, indent=1))
    return 1 if missing else 0


def _cmd_inspect(args) -> int:
    from libskylark_tpu_torch import engine
    from libskylark_tpu_torch.engine import aot, warmup

    try:
        manifest = warmup.read_manifest(args.pack)
    except Exception as e:  # noqa: BLE001 — the CLI reports, not raises
        print(f"error: unreadable manifest: {e!r}", file=sys.stderr)
        return 2
    ok, why = aot.compat_probe(manifest.get("compat"))
    fp = engine.plan_fingerprint()
    print(json.dumps({
        "schema": manifest.get("schema"),
        "entries": [
            {k: e.get(k) for k in ("name", "endpoint", "capacity",
                                   "kernel", "digest")}
            for e in manifest.get("entries", ())
        ],
        "uncaptured": manifest.get("uncaptured", []),
        "compat_ok_here": ok,
        "compat_reason": why,
        "plan_fingerprint": manifest.get("plan_fingerprint"),
        "plan_fingerprint_here": fp,
        "plan_fingerprint_match": fp == manifest.get("plan_fingerprint"),
    }, indent=1))
    return 0 if ok else 1


def _cmd_verify(args) -> int:
    from libskylark_tpu_torch import engine
    from libskylark_tpu_torch.engine import warmup

    report = warmup.load_pack(args.pack)
    s = engine.stats()
    report["aot_loads"] = s.aot_loads
    report["load_seconds"] = round(s.load_seconds, 4)
    report["backend_compiles"] = s.compiles
    print(json.dumps(report, indent=1))
    ok = (report["skipped"] is None and report["failed"] == 0
          and report["loaded"] == report["entries"])
    return 0 if ok else 1


def _cmd_boot_probe(args) -> int:
    import time

    from libskylark_tpu_torch.base import env as _env
    from libskylark_tpu_torch.engine import warmup

    report = warmup.serve_probe(args.pack, load=not args.no_load)
    # wall time since the parent spawned this process (SKYLARK_BOOT_T0):
    # the time to first result with the interpreter and imports in it
    t0 = _env.BOOT_T0.get()
    if t0 is not None:
        report["wall_since_spawn_s"] = round(time.time() - t0, 4)
    print("BOOT_PROBE " + json.dumps(report))
    ok = report["bit_equal"]
    if not args.no_load:
        # a pack that loaded partially still serves, capturing on first
        # traffic, but the probe must not certify it
        w = report["warmup"] or {}
        ok = (ok and w.get("skipped") is None and not w.get("failed")
              and (w.get("loaded", 0) + w.get("resident", 0)
                   == w.get("entries", -1)))
    return 0 if ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "build":
        return _cmd_build(args)
    if args.cmd == "inspect":
        return _cmd_inspect(args)
    if args.cmd == "boot-probe":
        return _cmd_boot_probe(args)
    return _cmd_verify(args)


if __name__ == "__main__":
    sys.exit(main())
