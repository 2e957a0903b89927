"""Graph BFS walks (SGSearch / SGWalk / GraphSearchTree equivalents).

Re-implementation of the reference's string-graph search machinery:
- SGWalk::getString(SGWT_START_TO_END)   StringGraph/SGWalk.cpp:161-290
- SGSearch::getTree                      StringGraph/SGSearch.cpp:50-56
- SGSearch::findWalks                    StringGraph/SGSearch.cpp:67-85
- GraphSearchTree BFS + node/distance limits
                                         StringGraph/GraphSearchTree.h:206-360

The BFS expands walks level by level; an edge's extension distance is its
unmatched seq length (SGDistanceFunction, SGSearch.h:20-26) and expansion
stops past `max_distance` or when the tree exceeds `max_nodes` (the walk set
is then flagged aborted, mirroring m_searchAborted).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core import alphabet as ab
from .core import EC_REVERSE, EC_SAME, ED_ANTISENSE, Edge, Vertex


@dataclass
class SGWalk:
    """A path of edge halves starting at `start` (StringGraph/SGWalk.h:34)."""

    start: Vertex
    edges: list = field(default_factory=list)

    def first_edge(self):
        return self.edges[0] if self.edges else None

    def last_edge(self):
        return self.edges[-1] if self.edges else None

    def last_vertex(self) -> Vertex:
        return self.edges[-1].end if self.edges else self.start

    def get_string(self) -> str:
        """SGWT_START_TO_END walk string (SGWalk.cpp:161-290)."""
        out = self.start.seq
        curr_comp = EC_SAME
        reverse_all = bool(self.edges) and self.edges[0].dir == ED_ANTISENSE
        if reverse_all:
            out = out[::-1]
        for e in self.edges:
            s = e.label()
            if curr_comp == EC_REVERSE:
                s = ab.revcomp_str(s)
            if reverse_all:
                s = s[::-1]
            comp_xz = curr_comp if e.comp == EC_SAME else 1 - curr_comp
            out += s
            curr_comp = comp_xz
        if reverse_all:
            out = out[::-1]
        return out


class _Node:
    __slots__ = ("vertex", "expand_dir", "parent", "edge", "distance",
                 "num_children")

    def __init__(self, vertex, expand_dir, parent, edge, dist_step):
        self.vertex = vertex
        self.expand_dir = expand_dir
        self.parent = parent
        self.edge = edge
        self.distance = 0 if parent is None else parent.distance + dist_step
        self.num_children = 0


def _walk_to(node: _Node) -> SGWalk:
    edges = []
    while node.parent is not None:
        edges.append(node.edge)
        node = node.parent
    edges.reverse()
    return SGWalk(node.vertex, edges)


def _search(root: Vertex, goal: Vertex | None, init_dir: int,
            max_distance: int, max_nodes: int):
    """GraphSearchTree.h:281-360: level-BFS with distance/node limits.
    Returns (leaf_nodes, goal_nodes, aborted)."""
    rootn = _Node(root, init_dir, None, None, 0)
    expand = [rootn]
    done: list[_Node] = []
    goals: list[_Node] = []
    total = 1
    aborted = False
    while expand:
        if total > max_nodes:
            done.extend(expand)
            expand = []
            aborted = True
            break
        incoming: list[_Node] = []
        while expand:
            node = expand.pop(0)
            if goal is not None and node.vertex is goal:
                goals.append(node)
                continue
            if node.distance > max_distance:
                done.append(node)
                continue
            edges = node.vertex.get_edges(node.expand_dir)
            for e in edges:
                child = _Node(e.end, 1 - e.twin.dir, node, e, e.seq_len())
                incoming.append(child)
                node.num_children += 1
            total += len(edges)
            if not edges:
                done.append(node)
            if total > max_nodes:
                done.extend(expand)
                expand = []
                break
        expand = incoming
        if total > max_nodes:
            done.extend(expand)
            expand = []
            aborted = True
    return done + expand, goals, aborted


def get_tree_walks(root: Vertex, init_dir: int, max_distance: int,
                   max_nodes: int) -> list[SGWalk]:
    """SGSearch::getTree: walks from root to every leaf of the BFS tree."""
    leaves, _, _ = _search(root, None, init_dir, max_distance, max_nodes)
    return [_walk_to(n) for n in leaves]


def find_walks(vx: Vertex, vy: Vertex, init_dir: int, max_distance: int,
               max_nodes: int, exhaustive: bool = True) -> tuple[list[SGWalk], bool]:
    """SGSearch::findWalks: all walks vx -> vy within max_distance.
    Returns (walks, complete); walks is empty when aborted and exhaustive."""
    _, goals, aborted = _search(vx, vy, init_dir, max_distance, max_nodes)
    if aborted and exhaustive:
        return [], False
    return [_walk_to(n) for n in goals], not aborted
