"""The port's clustering, t-SNE and nearest-neighbour server
(``deeplearning4j_tpu_torch.clustering``, ``plot``, ``server/
nearestneighbors.py``) held against the JAX package on the CPU.

Tolerances, float32 unless said:
* distances, trees, Barnes-Hut and the server: the same numpy code on
  both sides, so equal results (Barnes-Hut and the SpTree's forces within
  1e-6 all the same, as the float64 sums could be reordered);
* k-means: Lloyd's loop from JAX's own initial centres gives the same
  assignments and centres within 1e-5 (one GEMM and a one-hot product
  summed in another order); a whole ``apply_to`` seeds with its own
  generator, so on separated blobs it gives the same partition up to a
  permutation of the labels;
* ``_x2p_dense``: P within 1e-5 + 1e-4 |P|: both sides form d² as
  |x|² - 2 x·y + |y|² (JAX in f32, the port in f64), whose cancellation
  in f32 for points ~14 from the origin leaves d² ~1e-5 relative off, and
  exp(-beta d²) turns that into ~1e-4 of an entry (6.6e-5 measured with
  both in f32);
* ``_tsne_exact``: 1e-5 in relative 2-norm.  The loop amplifies rounding
  differences by its own dynamics: at the reference's defaults (lr 500,
  exaggeration 12) on a few hundred points the gap between two orders of
  summation doubles every iteration (float32 against float64 of one loop:
  2.7e-6 after 5 iterations, 1.0 after 20), so no tolerance holds 50 of
  them.  The 50-iteration case takes settings under which float32 and
  float64 of one loop stay within 5e-7 (lr 20, exaggeration 2, momentum
  and exaggeration switched at iteration 25, so both branches run); the
  defaults are held for their first 3 iterations.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.clustering as jcl
from deeplearning4j_tpu.clustering import distances as jdist
from deeplearning4j_tpu.clustering import kmeans as jkmeans
from deeplearning4j_tpu.plot import tsne as jtsne
from deeplearning4j_tpu.server import nearestneighbors as jnn
import deeplearning4j_tpu_torch.clustering as cl
from deeplearning4j_tpu_torch.clustering import distances as dist
from deeplearning4j_tpu_torch.clustering import kmeans as kmeans
from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne
from deeplearning4j_tpu_torch.plot import tsne
from deeplearning4j_tpu_torch.server import nearestneighbors as nn

TSNE_RTOL = 1e-5


def _blobs(n_per=50, centers=((0, 0), (10, 10), (-10, 10)), seed=0, d=2):
    rng = np.random.default_rng(seed)
    pts, labels = [], []
    for ci, c in enumerate(centers):
        base = np.zeros(d)
        base[:2] = c
        pts.append(rng.normal(size=(n_per, d)) + base)
        labels += [ci] * n_per
    return np.concatenate(pts).astype(np.float32), np.array(labels)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# Distances and trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jdist._DISTANCES))
def test_distances_equal_jax(name):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(40, 6))
    for q in (rng.normal(size=6), rng.normal(size=(5, 6))):
        np.testing.assert_array_equal(dist.distance_fn(name)(q, pts),
                                      jdist.distance_fn(name)(q, pts))


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
def test_vptree_knn_equals_jax_and_bruteforce(metric):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(150, 8))
    tree, jtree = cl.VPTree(pts, metric, seed=5), jcl.VPTree(pts, metric,
                                                             seed=5)
    for _ in range(10):
        q = rng.normal(size=8)
        idxs, dists = tree.knn(q, 5)
        assert (idxs, dists) == jtree.knn(q, 5)
        brute = np.argsort(np.atleast_1d(dist.distance_fn(metric)(q, pts)))
        assert set(idxs) == set(brute[:5].tolist())


def test_vptree_cosine_exact_on_many_queries():
    rng = np.random.default_rng(42)
    pts = rng.normal(size=(300, 8))
    tree = cl.VPTree(pts, "cosine", seed=1)
    for _ in range(40):
        q = rng.normal(size=8)
        idxs, dists = tree.knn(q, 5)
        brute_d = np.atleast_1d(dist.distance_fn("cosine")(q, pts))
        assert set(idxs) == set(np.argsort(brute_d)[:5].tolist())
        assert np.allclose(sorted(dists), np.sort(brute_d)[:5], atol=1e-9)


def test_vptree_rejects_dot_and_keeps_labels():
    with pytest.raises(ValueError):
        cl.VPTree(np.eye(3), "dot")
    tree = cl.VPTree(np.eye(4), "euclidean", labels=["a", "b", "c", "d"])
    assert tree.knn_labels(np.array([1.0, 0.1, 0, 0]), 1)[0] == ["a"]


def test_kdtree_equals_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(200, 5))
    tree, jtree = cl.KDTree.build(pts), jcl.KDTree.build(pts)
    for _ in range(10):
        q = rng.normal(size=5)
        p, d, i = tree.knn(q, 7)
        jp, jd, ji = jtree.knn(q, 7)
        assert i == ji
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(p, jp)
        brute = np.argsort(np.linalg.norm(pts - q, axis=1))[:7]
        assert set(i) == set(brute.tolist())
    grown, jgrown = cl.KDTree(2), jcl.KDTree(2)
    for i, p in enumerate([(0, 0), (5, 5), (1, 1), (9, 2)]):
        grown.insert(np.array(p, float), i)
        jgrown.insert(np.array(p, float), i)
    q = np.array([1.2, 1.1])
    assert grown.nn(q)[1:] == jgrown.nn(q)[1:] and grown.nn(q)[2] == 2


def test_sptree_forces_and_center_of_mass_equal_jax():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(64, 3))
    tree, jtree = cl.SpTree.build(pts), jcl.SpTree.build(pts)
    assert tree.cum_size == jtree.cum_size == 64
    np.testing.assert_allclose(tree.center_of_mass, jtree.center_of_mass,
                               rtol=1e-6, atol=1e-12)
    for theta in (0.0, 0.5):
        for q in pts[:8]:
            neg, sq = tree.compute_non_edge_forces(q, theta)
            jneg, jsq = jtree.compute_non_edge_forces(q, theta)
            np.testing.assert_allclose(neg, jneg, rtol=1e-6, atol=1e-12)
            assert sq == pytest.approx(jsq, rel=1e-6)
    # theta = 0 is the exact sum over the other points
    neg, sum_q = tree.compute_non_edge_forces(pts[0], 0.0)
    diff = pts[0] - pts[1:]
    qn = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
    assert np.isclose(sum_q, qn.sum(), rtol=1e-6)
    assert np.allclose(neg, (qn[:, None] ** 2 * diff).sum(0), rtol=1e-6)


def test_quadtree_is_2d_as_in_jax():
    pts = np.random.default_rng(7).normal(size=(32, 2))
    tree, jtree = cl.QuadTree.build(pts), jcl.QuadTree.build(pts)
    assert tree.cum_size == jtree.cum_size == 32
    np.testing.assert_allclose(tree.center_of_mass, jtree.center_of_mass,
                               rtol=1e-6)
    for mod in (cl, jcl):
        with pytest.raises(AssertionError):
            mod.QuadTree.build(np.zeros((4, 3)))


def test_cluster_objects():
    x, _ = _blobs(n_per=5)
    cs = cl.ClusterSet([cl.Cluster(center=x[0], id=0),
                        cl.Cluster(center=x[10], id=1)])
    assert cs.classify_point(cl.Point(x[11])) == 1
    assert cs.clusters[0].distance_to_center(cl.Point(x[0])) == 0.0
    assert len(cl.Point.to_points(x)) == len(x)


# ---------------------------------------------------------------------------
# K-means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,max_iter", [(3, 100), (5, 100), (5, 2)])
def test_lloyd_from_jax_centres_equals_jax(k, max_iter):
    """JAX's kernel with max_iter = 0 returns its k-means++ centres; the
    port's Lloyd loop from those centres ends where JAX's does."""
    x, _ = _blobs(n_per=60, d=4, seed=2)
    key = jax.random.PRNGKey(3)
    c0, _, it0 = jkmeans._kmeans_kernel(jnp.asarray(x), key, k, 0, 1e-4)
    assert int(it0) == 0
    jc, ja, jit = jkmeans._kmeans_kernel(jnp.asarray(x), key, k, max_iter,
                                         1e-4)
    c, a, it = kmeans.lloyd(torch.from_numpy(x),
                            torch.tensor(np.asarray(c0)), max_iter, 1e-4)
    assert it == int(jit)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)


def test_lloyd_decides_as_float64_on_vectors_sharing_a_direction():
    """Points that share one direction (mean cosine about 0.99, as a
    trained word-vector table's words do) and 20 clusters: Lloyd's loop
    in float32 takes the float64 loop's iterations and assignments, and
    its centres lie within 1e-6 of the float64 ones in relative 2-norm.
    Distances from the raw points cancel the shared direction and lose
    that (the port takes them from the centred points)."""
    rng = np.random.default_rng(5)
    n, d, k = 4_000, 128, 20
    topics = 0.03 * rng.normal(size=(k, d))
    x = (rng.normal(size=d) + topics[rng.integers(0, k, n)]
         + 0.1 * rng.normal(size=(n, d))).astype(np.float32)
    c0 = x[rng.choice(n, k, replace=False)]
    c32, a32, it32 = kmeans.lloyd(torch.from_numpy(x),
                                  torch.from_numpy(c0), 100, 1e-4)
    c64, a64, it64 = kmeans.lloyd(torch.from_numpy(x).double(),
                                  torch.from_numpy(c0).double(), 100, 1e-4)
    assert it32 == it64
    np.testing.assert_array_equal(a32.numpy(), a64.numpy())
    assert _rel(c32.double().numpy(), c64.numpy()) <= 1e-6


def test_lloyd_keeps_an_empty_cluster():
    x = np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]], np.float32)
    centres = np.array([[0.0, 0.0], [5.0, 5.0], [50.0, 50.0]], np.float32)
    c, a, _ = kmeans.lloyd(torch.from_numpy(x), torch.from_numpy(centres),
                           10, 1e-4)
    assert a.tolist() == [0, 0, 1]
    np.testing.assert_array_equal(c[2].numpy(), centres[2])


def _partition(assign):
    return {frozenset(np.flatnonzero(assign == k).tolist())
            for k in np.unique(assign)}


def test_apply_to_gives_jax_partition_up_to_labels():
    x, labels = _blobs()
    km = kmeans.KMeansClustering.setup(3, 100, "euclidean", seed=1,
                                       device="cpu")
    jkm = jkmeans.KMeansClustering.setup(3, 100, "euclidean", seed=1)
    cs, jcs = km.apply_to(x), jkm.apply_to(x)
    assert _partition(km.assignments_) == _partition(jkm.assignments_) == \
        _partition(labels)
    assert sorted(len(c.points) for c in cs.clusters) == \
        sorted(len(c.points) for c in jcs.clusters)
    pred = km.predict(np.array([[0.0, 0.0], [10.0, 10.0]], np.float32))
    assert pred[0] != pred[1]
    c = cs.nearest_cluster(cl.Point(np.array([10.0, 10.0])))
    assert np.linalg.norm(c.center - np.array([10, 10])) < 2.0
    # a list of Points and a tensor cluster alike
    km2 = kmeans.KMeansClustering(3, seed=1, device="cpu")
    km2.apply_to(cl.Point.to_points(x))
    np.testing.assert_array_equal(km2.assignments_, km.assignments_)
    km2.apply_to(torch.from_numpy(x))
    np.testing.assert_array_equal(km2.assignments_, km.assignments_)


def test_kmeans_and_tsne_need_a_device_without_cuda(monkeypatch):
    """With no CUDA device and no device asked for, they raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans.KMeansClustering(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tsne(n_iter=1).fit(np.zeros((4, 2), np.float32))


# ---------------------------------------------------------------------------
# t-SNE
# ---------------------------------------------------------------------------

def _tsne_inputs(n_per=300, d=16, seed=8):
    x, _ = _blobs(n_per=n_per, d=d, seed=seed)
    p = np.asarray(jtsne._x2p_dense(jnp.asarray(x), 30.0))
    p = np.maximum((p + p.T) / (2.0 * len(x)), 1e-12).astype(np.float32)
    y0 = (1e-4 * np.random.default_rng(seed).normal(
        size=(len(x), 2))).astype(np.float32)
    return x, p, y0


def test_x2p_dense_equals_jax():
    x, _ = _blobs(n_per=100, d=10, seed=4)
    for perplexity in (5.0, 30.0):
        want = np.asarray(jtsne._x2p_dense(jnp.asarray(x), perplexity))
        got = tsne._x2p_dense(torch.from_numpy(x), perplexity).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


def test_x2p_dense_keeps_to_float64_on_vectors_sharing_a_direction():
    """Points that share one direction (norm ~4.7, mean cosine about
    0.94, as a trained word-vector table's words do), 2,000 of them in 20
    topics: float32 P lies within 1e-5 + 1e-4 |P| of the float64 P, the
    rule the card is held to against the CPU.  d² formed in float32
    cancels the shared direction and misses the rule twice over (the
    port forms it in float64)."""
    rng = np.random.default_rng(0)
    n, d, k = 2_000, 128, 20
    topics = 0.03 * rng.normal(size=(k, d))
    x = torch.from_numpy((0.4 * rng.normal(size=d)
                          + topics[rng.integers(0, k, n)]
                          + 0.1 * rng.normal(size=(n, d))).astype(np.float32))
    got = tsne._x2p_dense(x, 30.0).double()
    want = tsne._x2p_dense(x.double(), 30.0)
    assert ((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all()


@pytest.mark.parametrize("n_iter,lr,switch,stop,exaggeration", [
    (50, 20.0, 25, 25, 2.0),       # a contracting loop, both branches
    (3, 500.0, 100, 250, 12.0),    # the reference's defaults
])
def test_tsne_exact_loop_equals_jax(n_iter, lr, switch, stop, exaggeration):
    _, p, y0 = _tsne_inputs()
    want = np.asarray(jtsne._tsne_exact(jnp.asarray(p), jnp.asarray(y0),
                                        n_iter, lr, switch, stop,
                                        exaggeration))
    got = tsne._tsne_exact(torch.from_numpy(p), torch.from_numpy(y0),
                           n_iter, lr, switch, stop, exaggeration).numpy()
    assert _rel(got, want) <= TSNE_RTOL


def _cluster_separation(y, labels):
    """Ratio of mean inter-class to mean intra-class distance."""
    intra, inter = [], []
    for i in range(0, len(y), 7):
        for j in range(i + 1, len(y), 7):
            d = np.linalg.norm(y[i] - y[j])
            (intra if labels[i] == labels[j] else inter).append(d)
    return np.mean(inter) / np.mean(intra)


def test_tsne_exact_separates_blobs():
    x, labels = _blobs(n_per=40, d=10, seed=8)
    y = Tsne(perplexity=15.0, n_iter=600, seed=9,
             device="cpu").fit_transform(x)
    assert y.shape == (120, 2) and np.all(np.isfinite(y))
    assert _cluster_separation(y, labels) > 2.0


def test_barnes_hut_equals_jax():
    x, labels = _blobs(n_per=10, d=4, seed=10)
    kw = dict(perplexity=5.0, theta=0.5, n_iter=30, seed=11)
    got = BarnesHutTsne(**kw).fit_transform(x)
    want = jtsne.BarnesHutTsne(**kw).fit_transform(x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_save_as_file_equals_jax(tmp_path):
    x, labels = _blobs(n_per=5, seed=12)
    kw = dict(perplexity=3.0, theta=0.5, n_iter=10, seed=13)
    names = [str(l) for l in labels]
    ts, jts = BarnesHutTsne(**kw).fit(x), jtsne.BarnesHutTsne(**kw).fit(x)
    ts.save_as_file(names, str(tmp_path / "port.csv"))
    jts.save_as_file(names, str(tmp_path / "jax.csv"))
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "jax.csv").read_text()
    assert len(text.strip().split("\n")) == 15


# ---------------------------------------------------------------------------
# The nearest-neighbour server
# ---------------------------------------------------------------------------

def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_base64_ndarray_round_trip():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(
        nn.base64_to_ndarray(nn.ndarray_to_base64(a)), a)
    assert nn.ndarray_to_base64(a) == jnn.ndarray_to_base64(a)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_nearest_neighbors_server_answers_as_jax(distance):
    """The cases of tests/test_servers.py through both servers: /knn of a
    stored point (itself excluded), /knnnew of a base64 body, 400 on a bad
    request, 404 on an unknown route."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 8)).astype(np.float32)
    servers = [nn.NearestNeighborsServer(pts, distance),
               jnn.NearestNeighborsServer(pts, distance)]
    try:
        answers = []
        for srv in servers:
            base = f"http://{srv.host}:{srv.port}"
            body = nn.ndarray_to_base64(pts[7])
            body["k"] = 3
            answers.append([_post(base + "/knn", {"ndarrayIndex": 3, "k": 5}),
                            _post(base + "/knnnew", body),
                            _post(base + "/knn", {"k": 2}),
                            _post(base + "/nothing", {"k": 2})])
        port, ref = answers
        assert port[:2] == ref[:2]
        (code, resp), (code_new, resp_new) = port[:2]
        assert code == code_new == 200
        results = resp["results"]
        assert len(results) == 5 and all(r["index"] != 3 for r in results)
        dists = [r["distance"] for r in results]
        assert dists == sorted(dists)
        assert resp_new["results"][0]["index"] == 7
        assert resp_new["results"][0]["distance"] < 1e-5
        assert port[2][0] == ref[2][0] == 400 and "error" in port[2][1]
        assert port[3][0] == ref[3][0] == 404
    finally:
        for srv in servers:
            srv.stop()
