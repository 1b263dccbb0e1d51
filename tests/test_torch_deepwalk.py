"""The port's graph modules (``deeplearning4j_tpu_torch/graph/``): the
cases of ``tests/test_graph.py`` through the port, and the port held
against the JAX package on the CPU, torch on one thread.

Exact: graphs, loaded files, every walker's walks for the same seed,
GraphHuffman's codes and points, and the vectors file for the same
tables (equal bytes).  A DeepWalk fit: every random draw is the same
numpy stream in both packages, so only rounding differs; the rule of
``tests/test_torch_embeddings.py`` for whole fits, ||port − jax|| ≤
FIT_REL · ||jax − initial|| per table, FIT_REL = 1e-5 (a rehearsal read
1.2e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.graph as port_graph
from deeplearning4j_tpu import graph as jax_graph
from deeplearning4j_tpu_torch.embeddings.lookup import TABLES
from deeplearning4j_tpu_torch.graph import (
    DeepWalk, Graph, GraphHuffman, GraphLoader, GraphVectorSerializer,
    Node2VecWalker, RandomWalkIterator, WeightedRandomWalkIterator)
from deeplearning4j_tpu_torch.graph.walkers import NoEdgesError

FIT_REL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_cliques(k=5, pkg=None):
    """Two k-cliques joined by a single bridge edge."""
    g = (pkg or Graph)(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j)
    g.add_edge(0, k)
    return g


def _deepwalk(pkg, device=None):
    b = pkg.DeepWalk.Builder().vector_size(16).window_size(3) \
        .learning_rate(0.05).epochs(3).seed(5)
    if device:
        b.device(device)
    dw = b.build()
    dw._walks_per_vertex = 10
    return dw


# ---------------------------------------------------- test_graph's cases


def test_graph_construction_and_queries():
    g = Graph(4)
    g.add_edge(0, 1)
    g.add_edge(1, 2, weight=2.0)
    g.add_edge(3, 0, directed=True)
    assert g.num_vertices() == 4
    assert g.get_vertex_degree(1) == 2
    assert g.get_connected_vertices(1) == [0, 2]
    assert g.get_connected_vertices(0) == [1]
    assert g.get_connected_vertices(3) == [0]
    assert g.get_vertex(2).idx == 2


def test_graph_loader_edge_list(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text("# comment\n0 1\n1 2\n2 3\n")
    g = GraphLoader.load_undirected_graph_edge_list_file(str(p), 4)
    assert g.get_connected_vertices(1) == [0, 2]
    w = tmp_path / "weighted.txt"
    w.write_text("0,1,0.5\n1,2,2.0\n")
    gw = GraphLoader.load_weighted_edge_list_file(str(w), 3, delim=",")
    assert gw.get_edges_out(0)[0].weight == 0.5
    a = tmp_path / "adj.txt"
    a.write_text("0 1 2\n1 0\n2 0\n")
    ga = GraphLoader.load_adjacency_list_file(str(a))
    assert ga.num_vertices() == 3
    assert set(ga.get_connected_vertices(0)) == {1, 2}
    ref = jax_graph.GraphLoader.load_adjacency_list_file(str(a))
    assert [ga.get_connected_vertices(i) for i in range(3)] == \
        [ref.get_connected_vertices(i) for i in range(3)]


def test_random_walk_properties():
    g = _two_cliques(4)
    walks = list(RandomWalkIterator(g, walk_length=10, seed=3))
    assert len(walks) == g.num_vertices()
    assert sorted(w[0] for w in walks) == list(range(g.num_vertices()))
    for w in walks:
        assert len(w) == 10
        for a, b in zip(w, w[1:]):
            assert b in g.get_connected_vertices(a)


def test_random_walk_no_edge_handling():
    g = Graph(2)
    g.add_edge(0, 1, directed=True)
    walks = {w[0]: w for w in RandomWalkIterator(g, 4, seed=0,
                                                 no_edge_handling="self_loop")}
    assert walks[1] == [1, 1, 1, 1]
    with pytest.raises(NoEdgesError):
        list(RandomWalkIterator(g, 4, seed=0, no_edge_handling="exception"))


def test_weighted_walk_follows_weights():
    g = Graph(3, allow_multiple_edges=True)
    g.add_edge(0, 1, weight=1000.0, directed=True)
    g.add_edge(0, 2, weight=1e-9, directed=True)
    g.add_edge(1, 0, directed=True)
    g.add_edge(2, 0, directed=True)
    seq = list(WeightedRandomWalkIterator(g, 20, seed=2))[0]
    trans = [b for a, b in zip(seq, seq[1:]) if a == 0]
    assert trans.count(1) >= len(trans) - 1


def test_node2vec_walker_valid_walks():
    g = _two_cliques(4)
    walks = list(Node2VecWalker(g, walk_length=8, p=0.5, q=2.0, seed=4))
    assert len(walks) == 8
    for w in walks:
        for a, b in zip(w, w[1:]):
            assert b in g.get_connected_vertices(a)


def test_graph_huffman_codes():
    g = Graph(7)
    for i in range(1, 7):
        g.add_edge(0, i)
    g.add_edge(1, 2)
    gh = GraphHuffman(g)
    codes = ["".join(str(b) for b in gh.get_code(i)) for i in range(7)]
    for i, ci in enumerate(codes):
        for j, cj in enumerate(codes):
            if i != j:
                assert not cj.startswith(ci)
    assert len(codes[0]) == min(len(c) for c in codes)
    assert gh.get_code_length(0) == len(codes[0])
    assert len(gh.get_path_inner_nodes(0)) == len(codes[0])


def test_deepwalk_embeds_cliques_closer():
    g = _two_cliques(6)
    dw = _deepwalk(port_graph,
                   device="cpu")
    dw.fit_graph(g, walk_length=20, seed=6)
    assert dw.get_vertex_vector(0).shape == (16,)
    intra = np.mean([dw.vertex_similarity(0, j) for j in range(1, 6)] +
                    [dw.vertex_similarity(6, 6 + j) for j in range(1, 6)])
    inter = np.mean([dw.vertex_similarity(i, 6 + j)
                     for i in range(1, 6) for j in range(1, 6)])
    assert intra > inter


def test_deepwalk_custom_walker_and_serialization(tmp_path):
    g = _two_cliques(4)
    dw = (DeepWalk.Builder().vector_size(8).window_size(2)
          .epochs(2).seed(7).device("cpu").build())
    dw.fit_walker(Node2VecWalker(g, walk_length=12, p=0.5, q=2.0, seed=8), g)
    path = tmp_path / "gv.txt"
    GraphVectorSerializer.write_graph_vectors(dw, str(path))
    loaded = GraphVectorSerializer.load_txt_vectors(str(path))
    assert len(loaded) == 8
    np.testing.assert_allclose(loaded[3], dw.get_vertex_vector(3), rtol=1e-5)


# ------------------------------------------------------ against JAX's


@pytest.mark.parametrize("walker", ["random", "weighted", "node2vec"])
def test_walks_equal_jax(walker):
    port_g = _two_cliques(5)
    ref_g = _two_cliques(5, jax_graph.Graph)
    for g in (port_g, ref_g):
        g.add_edge(2, 7, weight=3.0)
    make = {
        "random": lambda m, g: m.RandomWalkIterator(g, 15, seed=9),
        "weighted": lambda m, g: m.WeightedRandomWalkIterator(g, 15, seed=9),
        "node2vec": lambda m, g: m.Node2VecWalker(g, 15, p=0.5, q=2.0,
                                                  seed=9)}[walker]
    assert list(make(port_graph, port_g)) == list(make(jax_graph, ref_g))


def test_graph_huffman_equals_jax():
    port_g, ref_g = _two_cliques(6), _two_cliques(6, jax_graph.Graph)
    for g in (port_g, ref_g):
        g.add_edge(3, 9)
        g.add_edge(1, 11)
    port, ref = GraphHuffman(port_g), jax_graph.GraphHuffman(ref_g)
    for v in range(12):
        assert port.get_code(v) == ref.get_code(v)
        assert port.get_path_inner_nodes(v) == ref.get_path_inner_nodes(v)


def test_deepwalk_fit_equals_jax(tmp_path):
    port = _deepwalk(port_graph, device="cpu")
    ref = _deepwalk(jax_graph)
    port.fit_graph(_two_cliques(6), walk_length=20, seed=6)
    ref.fit_graph(_two_cliques(6, jax_graph.Graph), walk_length=20, seed=6)
    assert [(w.label, w.codes, w.points) for w in port.vocab.vocab_words()] \
        == [(w.label, w.codes, w.points) for w in ref.vocab.vocab_words()]
    init = (np.random.default_rng(5).random((12, 16), dtype=np.float32)
            - 0.5) / 16
    for name in TABLES:
        want = np.asarray(getattr(ref.lookup_table, name), np.float64)
        got = port.lookup_table.array(name)
        base = init if name == "syn0" else np.zeros_like(want)
        if np.array_equal(want, base):       # syn1neg: 1 row, never used
            np.testing.assert_array_equal(got, base)
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want - base)
        assert rel <= FIT_REL, f"{name}: {rel:.3g}"
    assert port.vertices_nearest(0, top=3) == ref.vertices_nearest(0, top=3)

    # the same tables write the same vectors file in both packages
    ref.lookup_table.syn0 = jnp.asarray(port.lookup_table.get_weights())
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    GraphVectorSerializer.write_graph_vectors(port, str(a))
    jax_graph.GraphVectorSerializer.write_graph_vectors(ref, str(b))
    assert a.read_bytes() == b.read_bytes()
    got = GraphVectorSerializer.load_txt_vectors(str(b))
    want = jax_graph.GraphVectorSerializer.load_txt_vectors(str(a))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
