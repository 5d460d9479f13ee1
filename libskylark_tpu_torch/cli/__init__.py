"""Command-line drivers (the port of libskylark_tpu/cli/).

Run as ``python -m libskylark_tpu_torch.cli.<name> [...]``; each module
exposes ``main(argv) -> int``. The port has ``skylark_warmup`` (warmup
packs, :mod:`libskylark_tpu_torch.engine.warmup`). The reference's other
drivers, and the helpers of this package they share (dataset reading,
matrix writing, streaming flags), come with them (ROADMAP A8).
"""
