"""The sharded minimizer lookup D3 (csrc/lookup.cu) and its plain
PyTorch version.

Replaces the per-shard half of minialign_tpu/parallel/shard.py:95
(make_sharded_lookup, jitted at :123; XLA): each shard's searchsorted
and found test. The cross-shard psum is the caller's sum over the shard
axis (shard.make_sharded_lookup). Tables hold uint64 hashes as int64
words with the same bits: PyTorch orders int64 signed, so the plain
version flips the sign bit before it compares (the kernel compares as
unsigned), which keeps the UINT64_MAX padding last.
"""

from __future__ import annotations

import torch

from .. import _build

SIGN = -(1 << 63)       # int64 with only the sign bit set


def _check(keys, starts, counts, q):
    dev = keys.device
    if keys.dim() != 2 or keys.shape[1] < 1:
        raise ValueError("lookup: keys must be (S, K) with K >= 1")
    for name, t in (("keys", keys), ("starts", starts), ("counts", counts)):
        if t.dtype != torch.int64 or t.shape != keys.shape or \
                t.device != dev or not t.is_contiguous():
            raise ValueError(f"lookup: {name} must be a contiguous (S, K) "
                             "int64 tensor on the keys' device")
    if q.dtype != torch.int64 or q.dim() != 1 or q.device != dev or \
            not q.is_contiguous():
        raise ValueError("lookup: q must be a contiguous (Q,) int64 tensor "
                         "on the keys' device")


def lookup_plain(keys: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, q: torch.Tensor):
    """(st, cn), each (S, Q) int64: query q[i]'s start and count in shard
    s (keys[s] sorted ascending as uint64), or 0 and 0. The kernel's
    lower_bound, every (shard, query) pair stepping together."""
    _check(keys, starts, counts, q)
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


def lookup(keys: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor,
           q: torch.Tensor):
    """lookup_plain's results on the inputs' device: one kernel launch
    over every (shard, query) pair for CUDA tensors (it launches or
    raises), lookup_plain for CPU tensors."""
    if keys.device.type == "cpu":
        return lookup_plain(keys, starts, counts, q)
    if keys.device.type != "cuda":
        raise ValueError(f"no lookup for device {keys.device}")
    _check(keys, starts, counts, q)
    S, K = keys.shape
    st = torch.empty((S, len(q)), dtype=torch.int64, device=keys.device)
    cn = torch.empty_like(st)
    if S and len(q):
        lib = _build.library()
        with torch.cuda.device(keys.device):
            rc = lib.lookup_launch(
                keys.data_ptr(), starts.data_ptr(), counts.data_ptr(), S, K,
                q.data_ptr(), len(q), st.data_ptr(), cn.data_ptr(),
                _build.stream_of(keys))
        _build.count("lookup")
        _build.check(lib, rc, "lookup kernel")
    return st, cn
