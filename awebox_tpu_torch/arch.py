"""Tree architecture bookkeeping for multi-kite AWE systems.

TPU-native re-design of the reference architecture bookkeeping
(awebox mdl/architecture.py:35-170). The architecture is pure
build-time Python: it resolves, before any tracing happens, the static tree
structure that determines every pytree shape downstream. Nothing here is ever
traced by JAX.

An architecture is described by a ``parent_map`` ``{node: parent}`` where node 0
is the ground station, e.g. ``{1: 0}`` (single kite), ``{1: 0, 2: 1, 3: 1}``
(dual kite on a Y-shaped tether tree).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class Architecture:
    parent_map: Dict[int, int]

    def __post_init__(self):
        nodes = sorted(self.parent_map.keys())
        expected = list(range(1, len(nodes) + 1))
        if nodes != expected:
            raise ValueError(
                f"parent_map keys must be 1..N, got {nodes}")
        for node, parent in self.parent_map.items():
            if parent >= node:
                raise ValueError(
                    f"node {node} must have a lower-numbered parent, got {parent}")

    # --- basic counts -----------------------------------------------------
    @property
    def number_of_nodes(self) -> int:
        """Number of nodes including the ground station (node 0)."""
        return len(self.parent_map) + 1

    @property
    def kite_nodes(self) -> List[int]:
        """Leaf nodes are kites."""
        parents = set(self.parent_map.values())
        return [n for n in sorted(self.parent_map.keys()) if n not in parents]

    @property
    def number_of_kites(self) -> int:
        return len(self.kite_nodes)

    @property
    def children_map(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for node, parent in sorted(self.parent_map.items()):
            out.setdefault(parent, []).append(node)
        return out

    @property
    def siblings_map(self) -> Dict[int, List[int]]:
        """node -> all nodes that share its parent (including itself)."""
        out = {}
        for node, parent in self.parent_map.items():
            out[node] = self.children_map[parent]
        return out

    @property
    def layer_nodes(self) -> List[int]:
        """Nodes whose children are kites ('layers' carrying kite rings)."""
        kites = set(self.kite_nodes)
        layers = sorted({self.parent_map[k] for k in kites})
        return layers

    @property
    def layers(self) -> int:
        return len(self.layer_nodes)

    @property
    def kites_map(self) -> Dict[int, List[int]]:
        """layer node -> kite children."""
        kites = set(self.kite_nodes)
        return {l: [c for c in self.children_map.get(l, []) if c in kites]
                for l in self.layer_nodes}

    # --- labels -----------------------------------------------------------
    def node_label(self, node: int) -> str:
        return f"{node}{self.parent_map[node]}"

    def parent_label(self, node: int) -> str:
        parent = self.parent_map[node]
        grandparent = self.parent_map.get(parent, 0)
        return f"{parent}{grandparent}"

    def get_all_level_siblings(self) -> Dict[int, List[int]]:
        """parent -> list of kite children at that level (reference
        architecture.py get_all_level_siblings)."""
        out: Dict[int, List[int]] = {}
        for kite in self.kite_nodes:
            parent = self.parent_map[kite]
            out.setdefault(parent, []).append(kite)
        return out


def from_user_input(seed) -> Architecture:
    """Accept {node: parent} dict."""
    if isinstance(seed, Architecture):
        return seed
    return Architecture(dict(seed))
