from pepr_tpu_torch.tree.basic import (Tree, parse_newick, to_newick, unroot,
                                 reroot_on_edge, replace_subtree,
                                 remove_taxa, leaf_distance_matrix)
from pepr_tpu_torch.tree.bipartition import (node_leafsets, bipartitions,
                                       rf_distance, decorate_supports)
from pepr_tpu_torch.tree.rooting import (compress_name, root_by_outgroup,
                                   mean_descendant_supports,
                                   normalize_supports)
from pepr_tpu_torch.tree.nj import neighbor_joining

__all__ = [
    "Tree", "parse_newick", "to_newick", "unroot", "reroot_on_edge",
    "replace_subtree", "remove_taxa", "leaf_distance_matrix",
    "node_leafsets", "bipartitions", "rf_distance", "decorate_supports",
    "compress_name", "root_by_outgroup", "mean_descendant_supports",
    "normalize_supports", "neighbor_joining",
]
