"""The sharded minimizer lookup D3 (csrc/lookup.cu) and its plain
PyTorch versions.

Replaces minialign_tpu/parallel/shard.py:95 (make_sharded_lookup,
jitted at :123; XLA): each shard's searchsorted and found test, and
the psum over the shards that share a device. Tables hold uint64
hashes as int64 words with the same bits: PyTorch orders int64 signed,
so the plain versions flip the sign bit before they compare (the
kernel compares as unsigned), which keeps the UINT64_MAX padding last.

The kernel searches a static tree of 128-byte nodes built once a table
(build_tree). A leaf block holds LB = 15 keys of the shard's sorted row
and, last, the next block's first key (UINT64_MAX past the row), so
that the key at lower_bound is always in the block it falls into. An
internal node holds NK = 16 separators and has FAN = 17 children,
separator i being the first key of child i + 1's subtree (UINT64_MAX
past the last child); the children of the lowest internal level are
leaf blocks. Descending to child #(separators < q) and counting the
leaf block's words < q gives lower_bound(q) (the last word is the next
block's first key, never < q there); the key there equals q exactly
when some word of the block does. Starts and counts are interleaved
into one (K, 2) pair table, so a hit is one 16-byte load. Each node and
leaf block also has a 32-byte summary, its words 3, 7, 11 and 15, so
that a level can be read by sectors (split): the summary says which of
the node's four sectors the count ends in, and only that one is read.
The kernel walks only the shards whose key range (bounds) holds the
query: lower_bound finds it in no other.

lookup_plain is the contract; lookup_tree_plain descends the tree level
by level as the kernel does (the tests hold the two equal, so a fault
of the tree's layout shows on the CPU, where the kernel cannot run).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build

SIGN = -(1 << 63)       # int64 with only the sign bit set
PAD = -1                # UINT64_MAX's bits as int64
NK = 16                 # words a node: 128 bytes, one line
FAN = NK + 1            # children an internal node
LB = NK - 1             # keys a leaf block (then the next block's first)
# The kernel's launch settings (csrc/lookup.cu; kbench.py --lookup's
# sweep on an H100, PERF.md): 4 lanes a query reading a level whole,
# one thread a query reading it by sectors, 256 threads a block, and the
# top levels that fit in SMEM_BUDGET bytes a block in shared memory
SMEM_BUDGET = 4 * 1024   # as lookup.cu's: 2 levels at 2 shards
SPLIT_QUERIES = 1 << 17  # queries from which to read by sectors, when
                         # the tree fits in L2 (whole lines won at 2^16)


class LookupTree(NamedTuple):
    """A table's search tree on its device: leaf (S, B, NK) int64, the B
    = ceil(K / LB) leaf blocks of each shard; nodes (S, N, NK) int64, the
    internal levels, root first (tree_levels); leaf_sums (S, B, 4) and
    node_sums (S, N, 4), the words 3, 7, 11, 15 of each; pairs (S, K, 2)
    int64, each key's start and count; bounds (S, 2), each row's first
    and last key; K, the keys a shard."""
    leaf: torch.Tensor
    nodes: torch.Tensor
    leaf_sums: torch.Tensor
    node_sums: torch.Tensor
    pairs: torch.Tensor
    bounds: torch.Tensor
    K: int

    @property
    def levels(self) -> list[int]:
        return tree_levels(self.K)

    def tables(self):
        """(keys, starts, counts): the (S, K) tables the tree was built
        from, for lookup_plain."""
        S = self.leaf.shape[0]
        return (self.leaf[..., :LB].reshape(S, -1)[:, :self.K].contiguous(),
                self.pairs[..., 0].contiguous(),
                self.pairs[..., 1].contiguous())

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self[:6])


def tree_levels(K: int) -> list[int]:
    """Nodes of each internal level of a shard of K keys, root first
    (none when the leaf is one block)."""
    n = -(-K // LB)
    out = []
    while n > 1:
        n = -(-n // FAN)
        out.append(n)
    return out[::-1]


def smem_bytes(S: int, K: int, levels: int, split: bool = False) -> int:
    """Shared memory a block for the top `levels` levels of S shards'
    trees (with their summaries when split)."""
    return S * sum(tree_levels(K)[:levels]) * (NK + 4 * split) * 8


def smem_levels(S: int, K: int, split: bool = False) -> int:
    """How many top levels of S shards' trees the kernel stages in shared
    memory: as many as fit in SMEM_BUDGET bytes."""
    t = 0
    while t < len(tree_levels(K)) and \
            smem_bytes(S, K, t + 1, split) <= SMEM_BUDGET:
        t += 1
    return t


def tree_bytes(S: int, K: int) -> int:
    """Bytes of S shards' leaf blocks and nodes, with their summaries: what
    a search reads besides the hits' pairs."""
    return S * (-(-K // LB) + sum(tree_levels(K))) * (NK + 4) * 8


def use_split(S: int, K: int, Q: int, l2_bytes: int = 50 << 20) -> bool:
    """Whether a launch over S shards of K keys and Q queries reads the
    levels by sectors: from SPLIT_QUERIES queries on (a query walks the
    one shard whose range holds it) when the tree fits in the card's L2
    (l2_bytes): then L2's bandwidth bounds the launch, and a sector read
    moves a quarter of a line. Otherwise (fewer queries: one chain's
    latency; a tree in HBM: its bursts) whole lines, one load a level."""
    return Q >= SPLIT_QUERIES and tree_bytes(S, K) <= l2_bytes


_L2: dict = {}


def _l2_bytes(dev: torch.device) -> int:
    if dev.index not in _L2:
        _L2[dev.index] = torch.cuda.get_device_properties(dev).L2_cache_size
    return _L2[dev.index]


def _check_tables(keys, starts, counts):
    if keys.dim() != 2 or keys.shape[1] < 1:
        raise ValueError("lookup: keys must be (S, K) with K >= 1")
    for name, t in (("keys", keys), ("starts", starts), ("counts", counts)):
        if t.dtype != torch.int64 or t.shape != keys.shape or \
                t.device != keys.device or not t.is_contiguous():
            raise ValueError(f"lookup: {name} must be a contiguous (S, K) "
                             "int64 tensor on the keys' device")


def _check_q(q, dev):
    if q.dtype != torch.int64 or q.dim() != 1 or q.device != dev or \
            not q.is_contiguous():
        raise ValueError("lookup: q must be a contiguous (Q,) int64 tensor "
                         "on the keys' device")


def build_tree(keys: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor) -> LookupTree:
    """The LookupTree of (S, K) tables (keys sorted ascending as uint64
    in each row), built with plain torch on their device."""
    _check_tables(keys, starts, counts)
    S, K = keys.shape
    dev = keys.device
    nb = -(-K // LB)
    # the rows padded with UINT64_MAX past the last block's next key
    kp = torch.full((S, nb * LB + 1), PAD, dtype=torch.int64, device=dev)
    kp[:, :K] = keys
    blk = torch.arange(nb, device=dev)[:, None] * LB
    leaf = kp[:, blk + torch.arange(NK, device=dev)]      # (S, nb, NK)
    levels = tree_levels(K)
    parts = []
    for d, n in enumerate(levels):
        # node k of this level, separator i: the first key of child
        # c = k FAN + i + 1, whose subtree starts at leaf block
        # c FAN^(levels below this one - 1); none past the last block
        span = FAN ** (len(levels) - d - 1)
        c = (torch.arange(n, device=dev)[:, None] * FAN
             + torch.arange(1, NK + 1, device=dev)).reshape(-1)
        b = c * span
        sep = kp[:, b.clamp(max=nb) * LB]
        parts.append(torch.where(b < nb, sep, PAD).reshape(S, n, NK))
    nodes = torch.cat(parts, 1) if parts else \
        torch.empty((S, 0, NK), dtype=torch.int64, device=dev)
    pairs = torch.stack([starts, counts], -1).contiguous()
    leaf = leaf.contiguous()
    return LookupTree(leaf, nodes, leaf[..., 3::4].contiguous(),
                      nodes[..., 3::4].contiguous(), pairs,
                      torch.stack([keys[:, 0], keys[:, -1]], -1), K)


def lookup_plain(keys: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, q: torch.Tensor):
    """(st, cn), each (S, Q) int64: query q[i]'s start and count in shard
    s (keys[s] sorted ascending as uint64), or 0 and 0. A lower_bound,
    every (shard, query) pair stepping together; the contract the kernel
    is held to."""
    _check_tables(keys, starts, counts)
    _check_q(q, keys.device)
    S, K = keys.shape
    kf = keys ^ SIGN
    qf = (q ^ SIGN)[None, :].expand(S, -1)
    lo = torch.zeros((S, len(q)), dtype=torch.int64, device=keys.device)
    n = torch.full_like(lo, K)
    while bool((n > 0).any()):
        half = n >> 1
        probe = torch.gather(kf, 1, (lo + half).clamp(max=K - 1))
        less = (probe < qf) & (n > 0)
        lo = torch.where(less, lo + half + 1, lo)
        n = torch.where(less, n - half - 1, half)
    ic = lo.clamp(max=K - 1)
    found = torch.gather(keys, 1, ic) == q[None, :]
    zero = torch.zeros_like(lo)
    return (torch.where(found, torch.gather(starts, 1, ic), zero),
            torch.where(found, torch.gather(counts, 1, ic), zero))


def _node(rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Row k[s, i] of rows (S, n, W), for every (shard, query): (S, Q,
    W)."""
    S, Q = k.shape
    return torch.gather(rows, 1, k[..., None].expand(S, Q, rows.shape[2]))


def _read(rows, sums, k, qf, split):
    """Node k of rows (S, n, NK) for every (shard, query), whole or, when
    split, only the sector that its summary (sums, (S, n, 4)) picks: (the
    node's count of words < q, the words read)."""
    if not split:
        node = _node(rows, k)
        return (node < qf).sum(-1), node
    j = (_node(sums, k)[..., :3] < qf).sum(-1)
    sec = _node(rows.reshape(rows.shape[0], -1, 4), k * 4 + j)
    return 4 * j + (sec < qf).sum(-1), sec


def lookup_tree_plain(tree: LookupTree, q: torch.Tensor,
                      split: bool = False):
    """lookup_plain's (st, cn), each (S, Q), found by descending the tree
    level by level as the kernel does: a node's count of separators < q
    picks the child; the leaf block's count of words < q gives the
    index, and q is found when a word of the block equals it. split:
    each level read by sectors, as the kernel's split launch reads the
    levels below shared memory."""
    leaf, nodes, leaf_sums, node_sums, pairs, _, K = tree
    _check_q(q, leaf.device)
    S = leaf.shape[0]
    qf = (q ^ SIGN)[None, :, None]
    k = torch.zeros((S, len(q)), dtype=torch.int64, device=leaf.device)
    rows, sums, off = nodes ^ SIGN, node_sums ^ SIGN, 0
    for n in tree.levels:
        c, _ = _read(rows[:, off:off + n], sums[:, off:off + n], k, qf,
                     split)
        k = k * FAN + c
        off += n
    c, words = _read(leaf ^ SIGN, leaf_sums ^ SIGN, k, qf, split)
    idx = k * LB + c
    found = (idx < K) & (words == qf).any(-1)
    ic = idx.clamp(max=K - 1)
    zero = torch.zeros_like(k)
    return (torch.where(found, torch.gather(pairs[..., 0], 1, ic), zero),
            torch.where(found, torch.gather(pairs[..., 1], 1, ic), zero))


def lookup_sum_plain(keys: torch.Tensor, starts: torch.Tensor,
                     counts: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """lookup's plain version: lookup_plain with the shards summed, as a
    (2, Q) int64 tensor (starts, counts)."""
    st, cn = lookup_plain(keys, starts, counts, q)
    return torch.stack([st.sum(0), cn.sum(0)])


def lookup(tree: LookupTree, q: torch.Tensor,
           split: bool | None = None) -> torch.Tensor:
    """(2, Q) int64 on the tree's device: each query's start and count,
    summed over the tree's shards (the psum of the shards on one
    device). One kernel launch for CUDA tensors (it launches or
    raises), lookup_sum_plain on the tree's tables for CPU tensors. split: the levels read by
    sectors (default: use_split)."""
    dev = tree.leaf.device
    if dev.type == "cpu":
        return lookup_sum_plain(*tree.tables(), q)
    if dev.type != "cuda":
        raise ValueError(f"no lookup for device {dev}")
    _check_q(q, dev)
    S = tree.leaf.shape[0]
    out = torch.empty((2, len(q)), dtype=torch.int64, device=dev)
    if len(q):
        if split is None:
            split = use_split(S, tree.K, len(q), _l2_bytes(dev))
        lib = _build.library()
        rc = lib.lookup_launch(
            tree.leaf.data_ptr(), tree.nodes.data_ptr(),
            tree.leaf_sums.data_ptr(), tree.node_sums.data_ptr(),
            tree.pairs.data_ptr(), tree.bounds.data_ptr(), S, tree.K,
            q.data_ptr(), len(q), out.data_ptr(), int(split), dev.index,
            torch._C._cuda_getCurrentRawStream(dev.index))
        _build.count("lookup")
        _build.check(lib, rc, "lookup kernel")
    return out
