"""Support decoration CLI (TreeSupportDecorator.java:21 main role;
PyTorch port of `pepr_tpu/tools/tree_support.py`).

Usage: python -m pepr_tpu_torch.tools.tree_support main.nwk supports.nwk
(supports file: one Newick per line).  Prints the decorated tree."""

from __future__ import annotations

import sys

from pepr_tpu_torch.tools import read_text
from pepr_tpu_torch.tree import decorate_supports, parse_newick, to_newick


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    main_tree = parse_newick(read_text(argv[0]))
    sup = [parse_newick(line) for line in read_text(argv[1]).splitlines()
           if line.strip()]
    print(to_newick(decorate_supports(main_tree, sup)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
