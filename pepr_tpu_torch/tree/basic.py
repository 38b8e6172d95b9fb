"""Flat-array rooted tree with Newick parse/serialize and topology edits.

The canonical tree representation of the framework: parent-pointer int
array + per-node label / branch-length / support arrays, the same data
model as the reference's BasicTree (BasicTree.java:131-409 parse,
:450-520 serialize, :669-813 unroot/root, :976-1077 subtree
replacement) re-designed as an immutable numpy structure with
functional edits (every operation returns a new Tree).

Conventions:
- nodes are 0..n-1; `parent[root] == -1`
- `blen[i]` / `support[i]` describe the edge from node i to its parent
  (NaN = absent)
- leaves are the nodes with no children; internal labels are stored as
  supports when numeric
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Tree:
    parent: np.ndarray  # int32 (n,)
    labels: list  # str | None per node
    blen: np.ndarray  # float64 (n,), NaN = absent
    support: np.ndarray  # float64 (n,), NaN = absent
    _children: list | None = field(default=None, repr=False, compare=False)
    _postorder: np.ndarray | None = field(default=None, repr=False,
                                          compare=False)

    # -- structure ---------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.parent)

    @property
    def root(self) -> int:
        return int(np.where(self.parent < 0)[0][0])

    @property
    def children(self) -> list:
        if self._children is None:
            ch: list[list[int]] = [[] for _ in range(self.n_nodes)]
            for i, p in enumerate(self.parent):
                if p >= 0:
                    ch[p].append(i)
            self._children = ch
        return self._children

    def is_leaf(self, i: int) -> bool:
        return len(self.children[i]) == 0

    def leaves(self) -> list[int]:
        return [i for i in range(self.n_nodes) if self.is_leaf(i)]

    def leaf_labels(self) -> list[str]:
        return [self.labels[i] for i in self.leaves()]

    def postorder(self) -> np.ndarray:
        """Children-before-parents node order."""
        if self._postorder is None:
            order: list[int] = []
            stack = [self.root]
            while stack:
                node = stack.pop()
                order.append(node)
                stack.extend(self.children[node])
            self._postorder = np.array(order[::-1], dtype=np.int32)
        return self._postorder

    def preorder(self) -> np.ndarray:
        return self.postorder()[::-1]

    def descendant_leaves(self, node: int) -> list[int]:
        out = []
        stack = [node]
        while stack:
            n = stack.pop()
            kids = self.children[n]
            if not kids:
                out.append(n)
            stack.extend(kids)
        return out

    def descendant_leaf_counts(self) -> np.ndarray:
        counts = np.zeros(self.n_nodes, dtype=np.int32)
        for node in self.postorder():
            kids = self.children[node]
            if not kids:
                counts[node] = 1
            else:
                counts[node] = sum(counts[k] for k in kids)
        return counts

    def copy(self) -> "Tree":
        return Tree(self.parent.copy(), list(self.labels),
                    self.blen.copy(), self.support.copy())

    def validate(self) -> None:
        assert (self.parent < 0).sum() == 1, "exactly one root"
        order = self.postorder()
        assert len(order) == self.n_nodes, "all nodes reachable"


# -- Newick parsing --------------------------------------------------------

def _try_float(s: str):
    try:
        return float(s)
    except ValueError:
        return None


def parse_newick(newick: str) -> Tree:
    """Parse a Newick string.  Supports branch lengths (:x), supports as
    internal-node labels and as bracketed [x] comments after ')' (the
    two forms the reference accepts, BasicTree.java:131-409,331-337)."""
    s = newick.strip()
    if s.endswith(";"):
        s = s[:-1]
    parents: list[int] = []
    labels: list = []
    blens: list[float] = []
    supports: list[float] = []

    has_child: list[bool] = []

    def new_node(parent: int) -> int:
        parents.append(parent)
        labels.append(None)
        blens.append(math.nan)
        supports.append(math.nan)
        has_child.append(False)
        if parent >= 0:
            has_child[parent] = True
        return len(parents) - 1

    i = 0
    n = len(s)
    root = new_node(-1)
    cur = root
    # cur is the node currently being described
    while i < n:
        c = s[i]
        if c == "(":
            cur = new_node(cur)
            i += 1
        elif c == ",":
            cur = new_node(parents[cur])
            i += 1
        elif c == ")":
            cur = parents[cur]
            i += 1
        elif c == ":":
            j = i + 1
            while j < n and s[j] not in ",():;[":
                j += 1
            blens[cur] = float(s[i + 1:j])
            i = j
        elif c == "[":
            j = s.index("]", i)
            val = _try_float(s[i + 1:j])
            if val is not None:
                supports[cur] = val
            i = j + 1
        elif c in " \t\n\r":
            i += 1
        else:
            # label (leaf name, or internal support/name after ')')
            if c == "'":
                j = s.index("'", i + 1)
                token = s[i + 1:j]
                i = j + 1
            else:
                j = i
                while j < n and s[j] not in ",():;[":
                    j += 1
                token = s[i:j].strip()
                i = j
            if len(parents) and not has_child[cur]:
                labels[cur] = token
            else:
                val = _try_float(token)
                if val is not None:
                    supports[cur] = val
                else:
                    labels[cur] = token
    return Tree(np.array(parents, dtype=np.int32), labels,
                np.array(blens), np.array(supports))


# -- Newick serialization --------------------------------------------------

def _fmt_num(x: float) -> str:
    x = float(x)
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(x)


def to_newick(tree: Tree, lengths: bool = True, supports: bool = True,
              node: int | None = None) -> str:
    """Serialize to Newick (support values as internal labels, the form
    written by the reference at BasicTree.java:450-520)."""

    out: list[str] = []

    def visit(i: int) -> None:
        kids = tree.children[i]
        if kids:
            out.append("(")
            for k, kid in enumerate(kids):
                if k:
                    out.append(",")
                visit(kid)
            out.append(")")
            if supports and not math.isnan(tree.support[i]):
                out.append(_fmt_num(tree.support[i]))
            elif tree.labels[i]:
                out.append(tree.labels[i])
        else:
            out.append(tree.labels[i] or "")
        if lengths and not math.isnan(tree.blen[i]) and \
                (node is not None or tree.parent[i] >= 0):
            out.append(":" + repr(float(tree.blen[i])))

    start = tree.root if node is None else node
    # Iterative wrapper to avoid recursion limits on deep trees.
    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, tree.n_nodes * 2 + 100))
    try:
        visit(start)
    finally:
        sys.setrecursionlimit(old)
    out.append(";")
    return "".join(out)


# -- topology edits (functional) ------------------------------------------

def _compact(parent, labels, blen, support, keep: np.ndarray) -> Tree:
    """Renumber nodes keeping only `keep` (bool mask)."""
    idx = np.where(keep)[0]
    remap = -np.ones(len(parent), dtype=np.int64)
    remap[idx] = np.arange(len(idx))
    new_parent = np.array([
        remap[parent[i]] if parent[i] >= 0 else -1 for i in idx],
        dtype=np.int32)
    return Tree(new_parent, [labels[i] for i in idx],
                np.asarray(blen, dtype=np.float64)[idx],
                np.asarray(support, dtype=np.float64)[idx])


def unroot(tree: Tree) -> Tree:
    """Collapse a degree-2 root: splice the root out, merging the two
    root edges (lengths summed, support of the merged edge kept).  The
    resulting root is the internal child if one exists
    (BasicTree.java:669-717 semantics)."""
    root = tree.root
    kids = tree.children[root]
    if len(kids) != 2:
        return tree.copy()
    a, b = kids
    # Prefer an internal node as the surviving root.
    if tree.is_leaf(a) and not tree.is_leaf(b):
        a, b = b, a
    parent = tree.parent.copy()
    blen = tree.blen.copy()
    support = tree.support.copy()
    labels = list(tree.labels)
    parent[a] = -1
    parent[b] = a
    sa, sb = blen[a], blen[b]
    if math.isnan(sa) and math.isnan(sb):
        merged = math.nan
    else:
        merged = (0.0 if math.isnan(sa) else sa) + \
                 (0.0 if math.isnan(sb) else sb)
    blen[b] = merged
    blen[a] = math.nan
    if math.isnan(support[b]) and not math.isnan(support[a]):
        support[b] = support[a]
    support[a] = math.nan
    keep = np.ones(tree.n_nodes, dtype=bool)
    keep[root] = False
    return _compact(parent, labels, blen, support, keep)


def reroot_on_edge(tree: Tree, node: int, fraction: float = 0.5) -> Tree:
    """Re-root the tree on the edge between `node` and its parent,
    placing the new root at `fraction` of the branch length from `node`
    (BasicTree.rootBetweenNodes, BasicTree.java:733-813).  The input is
    unrooted first if its root has degree 2 (re-rooting a rooted tree
    would otherwise leave a spurious degree-2 node)."""
    tree = unroot(tree)
    # `node` index may have changed after unrooting only if caller got it
    # from the unrooted tree; callers must pass indices valid for the
    # unrooted topology. We guard: if node is now the root, nothing to do.
    if tree.parent[node] < 0:
        return tree
    n = tree.n_nodes
    old_parent = tree.parent
    parent = tree.parent.copy()
    blen = np.append(tree.blen.copy(), math.nan)
    support = np.append(tree.support.copy(), math.nan)
    labels = list(tree.labels) + [None]
    new_root = n
    parent = np.append(parent, -1).astype(np.int32)

    # Split the (node, parent(node)) edge.
    p = int(old_parent[node])
    el = tree.blen[node]
    el = 0.0 if math.isnan(el) else el
    sup = tree.support[node]
    parent[node] = new_root
    blen[node] = el * fraction

    # Reverse the path p -> old_root: each ancestor becomes child of its
    # former child; edge data moves with the edge.
    prev = new_root
    prev_blen = el * (1.0 - fraction)
    prev_support = sup
    cur = p
    while cur >= 0:
        nxt = int(old_parent[cur])
        nxt_blen = tree.blen[cur]
        nxt_support = tree.support[cur]
        parent[cur] = prev
        blen[cur] = prev_blen
        support[cur] = prev_support
        prev = cur
        prev_blen = nxt_blen
        prev_support = nxt_support
        cur = nxt
    return Tree(parent, labels, blen, support)


def replace_subtree(tree: Tree, node: int, sub: Tree) -> Tree:
    """Replace the subtree below `node` with (rooted) `sub`, keeping the
    edge above `node` (length + support) intact.  The graft step of
    progressive refinement (AdvancedTree.replaceNode:1156-1207 /
    BasicTree.replaceSubtreeBelow:976-1077)."""
    # Drop all strict descendants of `node`.
    drop = np.zeros(tree.n_nodes, dtype=bool)
    stack = list(tree.children[node])
    while stack:
        k = stack.pop()
        drop[k] = True
        stack.extend(tree.children[k])
    keep_idx = np.where(~drop)[0]
    remap = -np.ones(tree.n_nodes, dtype=np.int64)
    remap[keep_idx] = np.arange(len(keep_idx))

    n_keep = len(keep_idx)
    n_sub = sub.n_nodes
    parent = np.empty(n_keep + n_sub, dtype=np.int32)
    blen = np.empty(n_keep + n_sub)
    support = np.empty(n_keep + n_sub)
    labels: list = []
    for j, i in enumerate(keep_idx):
        parent[j] = remap[tree.parent[i]] if tree.parent[i] >= 0 else -1
        blen[j] = tree.blen[i]
        support[j] = tree.support[i]
        labels.append(tree.labels[i])
    anchor = int(remap[node])
    sub_root = sub.root
    for j in range(n_sub):
        if j == sub_root:
            parent[n_keep + j] = -2  # placeholder, handled below
        else:
            parent[n_keep + j] = n_keep + sub.parent[j]
        blen[n_keep + j] = sub.blen[j]
        support[n_keep + j] = sub.support[j]
        labels.append(sub.labels[j])
    # The sub-root's children re-attach directly under the anchor node.
    for j in range(n_sub):
        if parent[n_keep + j] == n_keep + sub_root:
            parent[n_keep + j] = anchor
    # Remove the placeholder sub-root node.
    keep2 = np.ones(n_keep + n_sub, dtype=bool)
    keep2[n_keep + sub_root] = False
    t = _compact(parent, labels, blen, support, keep2)
    return t


def subtree_below(tree: Tree, node: int) -> Tree:
    """Extract the subtree rooted at `node` as a standalone Tree (the
    node becomes the new root; its parent-edge data is dropped)."""
    keep = np.zeros(tree.n_nodes, dtype=bool)
    stack = [node]
    while stack:
        n = stack.pop()
        keep[n] = True
        stack.extend(tree.children[n])
    parent = tree.parent.copy()
    blen = tree.blen.copy()
    support = tree.support.copy()
    parent[node] = -1
    blen[node] = math.nan
    support[node] = math.nan
    return _compact(parent, tree.labels, blen, support, keep)


def remove_taxa(tree: Tree, names: set[str]) -> Tree:
    """Remove leaves by label, then suppress any resulting degree-1
    internal nodes (merging branch lengths), as BasicTree.removeTaxon
    (BasicTree.java:888-946) does one-at-a-time."""
    t = tree
    changed = True
    while changed:
        changed = False
        drop = np.zeros(t.n_nodes, dtype=bool)
        for i in range(t.n_nodes):
            if t.is_leaf(i) and t.labels[i] in names and t.parent[i] >= 0:
                drop[i] = True
                changed = True
        if drop.any():
            t = _compact(t.parent, t.labels, t.blen, t.support, ~drop)
        # suppress unary internal nodes
        for i in range(t.n_nodes):
            kids = t.children[i]
            if len(kids) == 1 and not (t.is_leaf(i) and t.labels[i]):
                k = kids[0]
                parent = t.parent.copy()
                blen = t.blen.copy()
                support = t.support.copy()
                if t.parent[i] >= 0:
                    parent[k] = t.parent[i]
                    a, b = blen[k], blen[i]
                    if math.isnan(a) and math.isnan(b):
                        blen[k] = math.nan
                    else:
                        blen[k] = (0.0 if math.isnan(a) else a) + \
                                  (0.0 if math.isnan(b) else b)
                else:
                    parent[k] = -1
                    blen[k] = math.nan
                keep = np.ones(t.n_nodes, dtype=bool)
                keep[i] = False
                t = _compact(parent, t.labels, blen, support, keep)
                changed = True
                break
    return t


def ladderize(tree: Tree, ascending: bool = True) -> Tree:
    """Reorder children by descendant-leaf count (AdvancedTree's
    ladderize, AdvancedTree.java:221-244) — purely cosmetic ordering
    for stable, readable Newick output."""
    counts = tree.descendant_leaf_counts()
    out = tree.copy()
    ch: list[list[int]] = [list(k) for k in tree.children]
    for i in range(out.n_nodes):
        ch[i].sort(key=lambda k: (int(counts[k]),
                                  str(out.labels[k] or "")),
                   reverse=not ascending)
    out._children = ch
    return out


def node_coordinates(tree: Tree) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) drawing coordinates: x = root-to-node path length
    (phylogram), y = leaf index / mean of children
    (AdvancedTree.java:431-472, 798-854 role)."""
    n = tree.n_nodes
    x = np.zeros(n)
    y = np.zeros(n)
    for node in tree.preorder():
        p = tree.parent[node]
        if p >= 0:
            b = tree.blen[node]
            x[node] = x[p] + (0.0 if math.isnan(b) else b)
    leaf_i = 0
    for node in tree.postorder():
        kids = tree.children[node]
        if not kids:
            y[node] = leaf_i
            leaf_i += 1
        else:
            y[node] = float(np.mean([y[k] for k in kids]))
    return x, y


def leaf_distance_matrix(tree: Tree) -> tuple[np.ndarray, list[str]]:
    """Patristic (path-length) distances between all leaf pairs
    (BasicTree.java:1079-1116)."""
    leaves = tree.leaves()
    labels = [tree.labels[i] for i in leaves]
    n = tree.n_nodes
    # distance from each node up to root accumulated, then LCA via sets
    depth = np.zeros(n)
    order = tree.preorder()
    for node in order:
        p = tree.parent[node]
        if p >= 0:
            b = tree.blen[node]
            depth[node] = depth[p] + (0.0 if math.isnan(b) else b)
    # ancestors lists
    anc: list[list[int]] = []
    for leaf in leaves:
        chain = []
        cur = leaf
        while cur >= 0:
            chain.append(cur)
            cur = tree.parent[cur]
        anc.append(chain)
    pos = [dict((a, k) for k, a in enumerate(chain)) for chain in anc]
    m = len(leaves)
    dist = np.zeros((m, m))
    for i in range(m):
        for j in range(i + 1, m):
            lca = next(a for a in anc[i] if a in pos[j])
            d = depth[leaves[i]] + depth[leaves[j]] - 2 * depth[lca]
            dist[i, j] = dist[j, i] = d
    return dist, labels
