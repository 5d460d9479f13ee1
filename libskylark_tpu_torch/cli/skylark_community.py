"""skylark_community: seeded local community detection.

The port of libskylark_tpu/cli/skylark_community.py (ref: ml/
skylark_community.cpp:104-300): loads an arc-list graph, then finds a
low-conductance cluster around seed vertices via time-dependent PPR +
sweep cut; interactive mode reads seeds from stdin, batch mode takes them
on the command line. The diffusion and the sweep run on the host, as the
reference's do; ``--device`` is checked like every driver's.

Example::

    python -m libskylark_tpu_torch.cli.skylark_community graph.txt 0 -n -q \\
        --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from libskylark_tpu_torch.cli import add_device_arg

    p = argparse.ArgumentParser(
        prog="skylark_community",
        description="Seeded community detection "
        "(ref: ml/skylark_community.cpp)",
    )
    p.add_argument("graphfile", help="arc-list graph file")
    p.add_argument("seeds", nargs="*", help="seed vertices (batch mode)")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="read seed vertices from stdin, one line per query")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-r", "--recursive", action="store_true",
                   help="recursively expand the cluster as new seeds")
    p.add_argument("-c", "--cond", action="store_true",
                   help="in quiet mode prefix output with conductance")
    p.add_argument("--gamma", type=float, default=5.0)
    p.add_argument("--alpha", type=float, default=0.85)
    p.add_argument("--epsilon", type=float, default=0.001)
    p.add_argument("-n", "--numeric", action="store_true",
                   help="vertex names are numeric ids")
    add_device_arg(p)
    return p


def _run_query(G, seeds, args):
    from libskylark_tpu_torch.ml.graph import find_local_cluster

    t0 = time.time()
    cluster, cond = find_local_cluster(
        G, seeds, alpha=args.alpha, gamma=args.gamma,
        epsilon=args.epsilon, recursive=args.recursive,
    )
    elapsed = time.time() - t0
    members = " ".join(str(v) for v in sorted(cluster, key=str))
    if args.quiet:
        print(f"{cond:.3f} {members}" if args.cond else members)
    else:
        print(f"Conductance = {cond:.3f} (took {elapsed:.2e} sec)")
        print(f"Cluster: {members}")


def main(argv=None) -> int:
    from libskylark_tpu_torch.cli import honor_platform_env

    honor_platform_env()
    args = build_parser().parse_args(argv)
    from libskylark_tpu_torch.base.device import resolve_device
    from libskylark_tpu_torch.cli.skylark_graph_se import read_graph

    resolve_device(args.device)
    t0 = time.time()
    G = read_graph(args.graphfile, args.numeric)
    if not args.quiet:
        print(f"Reading the graph... took {time.time() - t0:.2e} sec")

    def parse_seed(tok):
        return int(tok) if args.numeric else tok

    if args.interactive:
        for line in sys.stdin:
            toks = line.split()
            if not toks:
                continue
            seeds = [parse_seed(t) for t in toks]
            missing = [s for s in seeds if not G.has_vertex(s)]
            if missing:
                print(f"seed(s) not in graph: {missing}", file=sys.stderr)
                continue
            _run_query(G, seeds, args)
        return 0

    if not args.seeds:
        print("error: no seeds given (use --interactive or list seeds)",
              file=sys.stderr)
        return 2
    seeds = [parse_seed(t) for t in args.seeds]
    missing = [s for s in seeds if not G.has_vertex(s)]
    if missing:
        print(f"error: seed(s) not in graph: {missing}", file=sys.stderr)
        return 2
    _run_query(G, seeds, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
