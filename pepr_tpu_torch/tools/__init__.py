"""Command-line tools beside the pipeline (PyTorch port of
`pepr_tpu/tools/`): tree comparison and per-site log-likelihoods, the AU
test, support decoration, set extraction, MinHash distances and the
tree-builder comparison.  Each runs as `python -m
pepr_tpu_torch.tools.<name>` with the JAX CLI's flags; the ones that
score trees take `-device cpu|cuda` (default: the card)."""


def read_text(path: str) -> str:
    with open(path) as fh:
        return fh.read()
