"""Run outputs: XML report, JSON tree, Newick/support/membership files
(PyTorch port of `pepr_tpu/pipeline/reports.py`; host code only).

Reproduces the reference's output surface: `<run>.report.xml`
(PEPRTracker.java:267-484), `<run>.nwk` (PhylogenomicPipeline2.java:
899-912), `<run>.sup` (:1111-1122), `<run>.hs` (:1320-1371),
`<run>_final_rooted.nwk/.json` (PhyloPipeline.java:596-615), and the
re-runnable `<run>.clp` (PhyloPipeline.java:1297-1314).
"""

from __future__ import annotations

import json
import os
import time
from xml.sax.saxutils import escape

from pepr_tpu_torch.tree import to_newick
from pepr_tpu_torch.tree.basic import Tree


def tree_to_json(tree: Tree) -> dict:
    """Nested-dict tree (BasicTree.java:1129-1166 JSON shape)."""

    def node_dict(i: int) -> dict:
        d: dict = {}
        if tree.is_leaf(i):
            d["name"] = tree.labels[i] or ""
        else:
            kids = [node_dict(k) for k in tree.children[i]]
            d["children"] = kids
            if tree.support is not None and not _isnan(tree.support[i]):
                d["support"] = float(tree.support[i])
        if not _isnan(tree.blen[i]) and tree.parent[i] >= 0:
            d["branch_length"] = float(tree.blen[i])
        return d

    return node_dict(tree.root)


def _isnan(x) -> bool:
    return x != x


class RunTracker:
    """Collects per-round run facts and writes the XML report
    (PEPRTracker role)."""

    def __init__(self, run_name: str):
        self.run_name = run_name
        self.started = time.time()
        self.rounds: list[dict] = []
        self.final_tree: str | None = None

    def new_round(self, name: str) -> dict:
        rec = {"name": name, "taxa": [], "genes": 0,
               "aligned_positions": 0, "trimmed_positions": 0,
               "tree_method": "", "support_method": "",
               "tree": "", "wall_seconds": {}, "outgroups": []}
        self.rounds.append(rec)
        return rec

    def to_xml(self) -> str:
        lines = ['<?xml version="1.0" encoding="UTF-8"?>',
                 f'<pepr_run name="{escape(self.run_name)}" '
                 f'elapsed_seconds="{time.time() - self.started:.1f}">']
        for rec in self.rounds:
            lines.append(f'  <round name="{escape(rec["name"])}">')
            lines.append(f'    <taxon_count>{len(rec["taxa"])}</taxon_count>')
            for t in rec["taxa"]:
                lines.append(f'    <taxon>{escape(t)}</taxon>')
            for og in rec["outgroups"]:
                lines.append(f'    <outgroup>{escape(og)}</outgroup>')
            lines.append(f'    <gene_count>{rec["genes"]}</gene_count>')
            lines.append('    <aligned_positions>'
                         f'{rec["aligned_positions"]}</aligned_positions>')
            lines.append('    <trimmed_positions>'
                         f'{rec["trimmed_positions"]}</trimmed_positions>')
            lines.append(f'    <tree_method>{escape(rec["tree_method"])}'
                         '</tree_method>')
            lines.append('    <support_method>'
                         f'{escape(rec["support_method"])}</support_method>')
            if rec.get("gamma_alpha") is not None:
                lines.append('    <gamma_alpha>'
                             f'{rec["gamma_alpha"]:.4f}</gamma_alpha>')
            if rec.get("substitution_model"):
                lines.append('    <substitution_model>'
                             f'{escape(rec["substitution_model"])}'
                             '</substitution_model>')
            for phase, secs in rec["wall_seconds"].items():
                lines.append(f'    <timing phase="{escape(phase)}" '
                             f'seconds="{secs:.2f}"/>')
            if rec["tree"]:
                lines.append(f'    <tree>{escape(rec["tree"])}</tree>')
            lines.append('  </round>')
        if self.final_tree:
            lines.append(f'  <final_tree>{escape(self.final_tree)}'
                         '</final_tree>')
        lines.append('</pepr_run>')
        return "\n".join(lines) + "\n"


def write_outputs(out_dir: str, run_name: str, tracker: RunTracker,
                  rooted_tree: Tree, support_trees=None, hs_text=None,
                  clp_args=None) -> dict[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    paths: dict[str, str] = {}

    def put(suffix: str, content: str) -> None:
        path = os.path.join(out_dir, f"{run_name}{suffix}")
        with open(path, "w") as fh:
            fh.write(content)
        paths[suffix] = path

    nwk = to_newick(rooted_tree)
    tracker.final_tree = nwk
    put("_final_rooted.nwk", nwk + "\n")
    put("_final_rooted.json", json.dumps(tree_to_json(rooted_tree),
                                         indent=1) + "\n")
    put(".nwk", nwk + "\n")
    if support_trees:
        put(".sup", "".join(to_newick(t) + "\n" for t in support_trees))
    if hs_text:
        put(".hs", hs_text)
    if clp_args:
        put(".clp", "\n".join(clp_args) + "\n")
    put(".report.xml", tracker.to_xml())
    return paths
