"""The port's graph store and sampler against the reference's.

``repro_torch.data.graph`` is a numpy copy of ``repro.data.graph`` that
makes the same random draws in the same order, so at equal seeds the
graph, the sampled blocks, the labels and the per-store bytes must be
EQUAL (not close) to the reference's.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import graph as ref
from repro_torch.data import graph as port

GRAPHS = [
    dict(n_nodes=3000, n_parts=4, seed=0),
    dict(n_nodes=2000, avg_degree=8, n_feats=32, n_classes=7, n_parts=3,
         train_frac=0.2, seed=5),
]


@pytest.mark.parametrize("kw", GRAPHS)
def test_synthetic_graph_equals_reference(kw):
    a, b = ref.synthetic_graph(**kw), port.synthetic_graph(**kw)
    for name in ("indptr", "indices", "feats", "labels", "train_nodes"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name
    assert a.n_parts == b.n_parts and a.n_nodes == b.n_nodes
    nodes = np.arange(a.n_nodes)
    assert np.array_equal(a.part_of(nodes), b.part_of(nodes))


@pytest.mark.parametrize("fanouts,batch,seed", [
    ((5, 5), 128, 0), ((5, 10, 15), 128, 1), ((3,), 64, 2),
])
def test_sample_blocks_equals_reference(fanouts, batch, seed):
    g_ref = ref.synthetic_graph(n_nodes=3000, n_parts=4, seed=0)
    g_port = port.synthetic_graph(n_nodes=3000, n_parts=4, seed=0)
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # the second batch checks the streams stay in step
        seeds_a = rng_a.choice(g_ref.train_nodes, batch, replace=False)
        seeds_b = rng_b.choice(g_port.train_nodes, batch, replace=False)
        fa, ba, la, sa = ref.sample_blocks(g_ref, seeds_a, fanouts, rng_a)
        fb, bb, lb, sb = port.sample_blocks(g_port, seeds_b, fanouts, rng_b)
        assert np.array_equal(fa, fb) and fa.dtype == fb.dtype
        assert len(ba) == len(bb) == len(fanouts)
        for x, y, k in zip(ba, bb, fanouts):
            assert x.dtype == y.dtype == np.int32
            assert x.shape[1] == k
            assert np.array_equal(x, y)
        assert np.array_equal(la, lb) and lb.dtype == np.int64
        assert sa == sb
        assert sum(sb.values()) == fb.shape[0] * fb.shape[1] * 4


def test_sample_support_equals_reference():
    g_ref = ref.synthetic_graph(n_nodes=3000, n_parts=4, seed=0)
    g_port = port.synthetic_graph(n_nodes=3000, n_parts=4, seed=0)
    seeds = g_ref.train_nodes[:50]
    la, ba = ref.sample_support(g_ref, seeds, (4, 6), np.random.default_rng(3))
    lb, bb = port.sample_support(g_port, seeds, (4, 6), np.random.default_rng(3))
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert all(np.array_equal(x, y) for x, y in zip(ba, bb))
    # seed-first layout: every layer's targets are a prefix of the next
    for inner, outer in zip(lb, lb[1:]):
        assert np.array_equal(outer[: len(inner)], inner)
