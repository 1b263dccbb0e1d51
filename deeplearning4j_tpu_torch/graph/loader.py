"""Graph file loaders (ref: data/GraphLoader.java —
loadUndirectedGraphEdgeListFile, loadWeightedEdgeListFile,
loadAdjacencyListFile)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.graph.graph import Graph


class GraphLoader:
    @staticmethod
    def load_undirected_graph_edge_list_file(path: str, n_vertices: int,
                                             delim: str = None) -> Graph:
        """Lines "i<delim>j" (ref: GraphLoader.loadUndirectedGraphEdgeListFile)."""
        g = Graph(n_vertices)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delim)
                g.add_edge(int(parts[0]), int(parts[1]))
        return g

    @staticmethod
    def load_weighted_edge_list_file(path: str, n_vertices: int,
                                     delim: str = None,
                                     directed: bool = False) -> Graph:
        """Lines "i<delim>j<delim>w" (ref: GraphLoader.loadWeightedEdgeListFile)."""
        g = Graph(n_vertices)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delim)
                g.add_edge(int(parts[0]), int(parts[1]), float(parts[2]),
                           directed)
        return g

    @staticmethod
    def load_adjacency_list_file(path: str, n_vertices: int = None,
                                 delim: str = None) -> Graph:
        """Line per vertex: "v n1 n2 ..." (ref: GraphLoader.loadAdjacencyListFile)."""
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([int(p) for p in line.split(delim)])
        n = n_vertices or (max(max(r) for r in rows if r) + 1)
        g = Graph(n)
        for r in rows:
            for dst in r[1:]:
                g.add_edge(r[0], dst, directed=True)
        return g
