"""skylark_graph_se: approximate adjacency spectral embedding of a graph.

The port of libskylark_tpu/cli/skylark_graph_se.py (ref: ml/
skylark_graph_se.cpp): reads an arc-list graph, runs ApproximateASE on
``--device``, writes prefix.V.txt (embedding vectors) and
prefix.index.txt (vertex order).

Example::

    python -m libskylark_tpu_torch.cli.skylark_graph_se graph.txt -k 6 -n \\
        --device cuda --prefix out
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from libskylark_tpu_torch.cli import add_device_arg

    p = argparse.ArgumentParser(
        prog="skylark_graph_se",
        description="Approximate adjacency spectral embedding "
        "(ref: ml/skylark_graph_se.cpp)",
    )
    p.add_argument("graphfile", help="arc-list graph file")
    p.add_argument("-s", "--seed", type=int, default=38734)
    p.add_argument("-k", "--rank", type=int, default=6)
    p.add_argument("-i", "--powerits", type=int, default=2)
    p.add_argument("--skipqr", action="store_true")
    p.add_argument("-r", "--ratio", type=int, default=2)
    p.add_argument("-a", "--additive", type=int, default=0)
    p.add_argument("-n", "--numeric", action="store_true",
                   help="vertex names are numeric ids")
    p.add_argument("--prefix", default="out")
    add_device_arg(p)
    return p


def read_graph(path: str, numeric: bool):
    """An arc-list file as a :class:`~libskylark_tpu_torch.ml.graph.Graph`
    (``#`` lines and blank lines skipped; ``numeric`` reads the vertex
    names as ints). ``Graph.add_edge`` inserts both directions."""
    from libskylark_tpu_torch.ml.graph import Graph

    G = Graph()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            u, v = toks[0], toks[1]
            if numeric:
                u, v = int(u), int(v)
            G.add_edge(u, v)
    return G


def main(argv=None) -> int:
    from libskylark_tpu_torch.cli import honor_platform_env

    honor_platform_env()
    args = build_parser().parse_args(argv)

    from libskylark_tpu_torch.base.context import Context
    from libskylark_tpu_torch.base.device import resolve_device
    from libskylark_tpu_torch.cli import write_ascii_matrix
    from libskylark_tpu_torch.ml.graph import approximate_ase
    from libskylark_tpu_torch.nla.svd import ApproximateSVDParams

    device = resolve_device(args.device)
    t0 = time.time()
    G = read_graph(args.graphfile, args.numeric)
    print(f"Reading the graph... took {time.time() - t0:.2e} sec")

    params = ApproximateSVDParams(
        num_iterations=args.powerits,
        oversampling_ratio=args.ratio,
        oversampling_additive=args.additive,
        skip_qr=args.skipqr,
    )
    t0 = time.time()
    X, indexmap = approximate_ase(G, args.rank, Context(seed=args.seed),
                                  params, device=device)
    print(f"Computing embeddings... took {time.time() - t0:.2e} sec")

    write_ascii_matrix(args.prefix + ".V.txt", X)
    with open(args.prefix + ".index.txt", "w") as f:
        for v in indexmap:
            f.write(f"{v}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
