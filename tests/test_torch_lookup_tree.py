"""D3's search tree (minialign_tpu_torch.parallel.cuda_lookup) on the
CPU: lookup_tree_plain, which descends the tree of 128-byte nodes as the
kernel does, equals lookup_plain (the contract) shard for shard and word
for word, and their sum over the shards equals the JAX package's
make_sharded_lookup on conftest's virtual mesh (under
jax.enable_x64(True): the JAX lookup cuts hashes to 32 bits without it).
On kbench.LOOKUP_KINDS and on shards of K keys around the node size and
its powers, with all-pad shards, hashes past 2^32, the pad query,
repeated queries and no query; then the tree's invariants and the
shared-memory level choice. Every comparison is exact."""

import jax
import numpy as np
import pytest
import torch

import minialign_tpu.parallel.shard as jshard
from minialign_tpu_torch import kbench
from minialign_tpu_torch.index.build import build_index
from minialign_tpu_torch.params import IndexParams
from minialign_tpu_torch.parallel import cuda_lookup as cl
from minialign_tpu_torch.parallel import shard

U64MAX = np.iinfo(np.uint64).max
EDGE_K = kbench.LOOKUP_EDGE_K


def _check_all(tabs, q, n, split):
    """lookup_tree_plain (whole nodes, or split: read by sectors) ==
    lookup_plain per shard, their sum == the wrapper's CPU path == JAX
    make_sharded_lookup over n devices."""
    *t, qt = kbench.lookup_tensors(torch, tabs, q, "cpu")
    tree = cl.build_tree(*t)
    want = cl.lookup_plain(*t, qt)
    got = cl.lookup_tree_plain(tree, qt, split)
    assert got[0].shape == (n, len(q))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and torch.equal(g, w)
    summed = cl.lookup(tree, qt)
    assert torch.equal(summed, torch.stack([w.sum(0) for w in want]))
    with jax.enable_x64(True):
        jst, jcn = jshard.make_sharded_lookup(jshard.make_mesh(n))(
            *tabs, jax.numpy.asarray(np.asarray(q, np.uint64)))
    assert np.array_equal(summed[0].numpy(), np.asarray(jst, np.int64))
    assert np.array_equal(summed[1].numpy(), np.asarray(jcn, np.int64))
    return summed


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("kind", kbench.LOOKUP_KINDS)
def test_tree_plain_matches_plain_and_jax(kind, n, split):
    keys, off = kbench.lookup_table(kind, build_index, IndexParams)
    _check_all(shard.shard_index_arrays(keys, off, n),
               kbench.lookup_queries(keys), n, split)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("K", EDGE_K)
def test_tree_plain_on_edge_sizes(K, n, split):
    """K keys a shard around one leaf block (15), one node (16), one
    node's children (17) and their powers; shards part pad and all
    pad."""
    tabs = kbench.lookup_edge_tables(K, n, seed=K * 10 + n)
    q = kbench.lookup_edge_queries(tabs[0])
    got = _check_all(tabs, q, n, split)
    # a real key is found exactly once; the pad value and misses are not
    keys = np.asarray(tabs[0], np.uint64).ravel()
    real = np.isin(q, keys[keys != U64MAX])
    assert (got[1].numpy()[real] > 0).all()
    assert (got[1].numpy()[~real] == 0).all()


@pytest.mark.parametrize("n", [1, 8])
def test_tree_plain_with_no_query(n):
    tabs = kbench.lookup_edge_tables(257, n)
    *t, _ = kbench.lookup_tensors(torch, tabs, np.zeros(0, np.uint64), "cpu")
    q = torch.zeros(0, dtype=torch.int64)
    tree = cl.build_tree(*t)
    assert [x.shape for x in cl.lookup_tree_plain(tree, q)] == [(n, 0)] * 2
    assert cl.lookup(tree, q).shape == (2, 0)


@pytest.mark.parametrize("K", EDGE_K + (17 * 17 * 15, 17 * 17 * 15 + 1))
def test_tree_invariants(K):
    """A leaf block holds 15 keys of the row, padded with UINT64_MAX, then
    the next block's first key (UINT64_MAX after the last); every
    level, read in node order, is sorted as uint64; separator i of node
    k is the first key of child k 17 + i + 1 (found by walking down its
    leftmost children), UINT64_MAX past the last child; the pair table
    holds each key's start and count."""
    tabs = kbench.lookup_edge_tables(K, 2, seed=K)
    t = kbench.lookup_tensors(torch, tabs, np.zeros(0, np.uint64), "cpu")[:3]
    tree = cl.build_tree(*t)
    leaf = tree.leaf.numpy().view(np.uint64)
    nb = -(-K // 15)
    assert leaf.shape == (2, nb, 16)
    row = np.full((2, nb * 15 + 1), U64MAX, np.uint64)
    row[:, :K] = np.asarray(tabs[0], np.uint64)
    for b in range(nb):
        assert np.array_equal(leaf[:, b, :15], row[:, 15 * b:15 * b + 15])
        assert np.array_equal(leaf[:, b, 15], row[:, 15 * b + 15])
    assert np.array_equal(tree.pairs.numpy(), np.stack(tabs[1:], -1))
    # each row's first and last key (the kernel skips a shard whose range
    # cannot hold the query)
    assert np.array_equal(tree.bounds.numpy().view(np.uint64), np.stack(
        [np.asarray(tabs[0], np.uint64)[:, 0],
         np.asarray(tabs[0], np.uint64)[:, -1]], -1))
    # the sector summaries: words 3, 7, 11, 15 of each block and node
    assert torch.equal(tree.leaf_sums, tree.leaf[..., 3::4])
    assert torch.equal(tree.node_sums, tree.nodes[..., 3::4])
    assert all(np.array_equal(x.numpy(), y) for x, y in
               zip(tree.tables(), (np.asarray(tabs[0]).view(np.int64),
                                   *tabs[1:])))
    levels = cl.tree_levels(K)
    assert tree.nodes.shape == (2, sum(levels), 16)
    assert (levels == []) == (nb == 1)
    if levels:
        assert levels[0] == 1 and -(-nb // 17) == levels[-1]
    nodes = tree.nodes.numpy().view(np.uint64)
    off = 0
    for d, n in enumerate(levels):
        lv = nodes[:, off:off + n].reshape(2, -1)
        assert (np.diff(lv.astype(object), axis=1) >= 0).all()
        below = levels[d + 1:]      # the levels under this one, top down
        for k in range(n):
            for i in range(16):
                c = k * 17 + i + 1
                for m in below:     # down the leftmost children
                    if c >= m:
                        break
                    c *= 17
                else:
                    if c < nb:
                        assert (nodes[:, off + k, i] == leaf[:, c, 0]).all()
                        continue
                assert (nodes[:, off + k, i] == U64MAX).all()
        off += n


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("S", [1, 2, 8])
def test_smem_levels_fit_the_budget(S, split):
    """The kernel stages as many top levels as fit in SMEM_BUDGET (128
    bytes a node, 160 with its summary when split): the chosen levels
    fit and one more would not (or there is none)."""
    per = 160 if split else 128
    for K in EDGE_K + (496_882, 5_000_000):
        levels = cl.tree_levels(K)
        t = cl.smem_levels(S, K, split)
        size = [S * sum(levels[:j]) * per for j in range(len(levels) + 1)]
        assert size == [cl.smem_bytes(S, K, j, split)
                        for j in range(len(levels) + 1)]
        assert size[t] <= cl.SMEM_BUDGET
        assert t == len(levels) or size[t + 1] > cl.SMEM_BUDGET
