"""Distributed data-movement verbs (counterpart of sctl_tpu/comm/verbs.py;
reference: comm.txx — PartitionW:540, PartitionN:625, PartitionS:696,
SortScatterIndex:730, ScatterForward:811, ScatterReverse:936,
HyperQuickSort:1159).

The JAX package's ragged convention is kept, so that each rank's blocks
equal the JAX verbs' shard for shard: a rank's distributed array is a
buffer of static capacity C (leading axis) and a valid count `cnt`;
slots >= cnt are padding.  Every verb takes and returns (data, cnt)
pairs where `data` may be a dict, list or tuple of tensors sharing the
leading axis.  Counts are int64 tensors (or Python ints on input).

`alltoallv` gathers the (p, p) send counts once and moves the rows with
one ragged `all_to_all_single` a tensor (split sizes from the counts);
`alltoallv_ring` rotates each rank's whole buffer p - 1 times around the
ring, O(C) staging, as the JAX package's ring does.  `global_sort` is
the JAX package's sample sort.  On the self-communicator every verb is
the JAX package's p = 1 form.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .comm import Comm, exclusive_cumsum, tree_leaves, tree_map


def ragged_route_tables(src, payload, dst, places, ndev, fill=-1):
    """Host-side builder of sparse cnt/dsp-ragged static routing tables
    for `alltoallv` (sctl_tpu/comm/verbs.py:40-113; reference:
    Ialltoallv_sparse, comm.txx:363).  Row m sends local payload index
    payload[m] from rank src[m] to rank dst[m], landing at places[k][m]
    on the receiver.  Returns (send_idx (ndev, Cs) grouped by
    destination, send_cnt (ndev, ndev), recv_places [(ndev, Cr)], Cs,
    Cr, recv_pos (M,)), numpy; rows keep their relative order within
    each (src, dst) pair."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    M = len(src)
    if M == 0:
        one = np.full((ndev, 1), fill, np.int64)
        return (one, np.zeros((ndev, ndev), np.int64),
                [one.copy() for _ in places], 1, 1, np.zeros(0, np.int64))
    cnt = np.zeros((ndev, ndev), np.int64)
    np.add.at(cnt, (src, dst), 1)
    tot_s, tot_r = cnt.sum(axis=1), cnt.sum(axis=0)
    Cs, Cr = max(1, int(tot_s.max())), max(1, int(tot_r.max()))
    o_s = np.argsort(src * np.int64(ndev) + dst, kind="stable")
    dsp_s = np.concatenate([[0], np.cumsum(tot_s)])
    pos_s = np.arange(M) - dsp_s[src[o_s]]
    send_idx = np.full((ndev, Cs), fill, np.int64)
    send_idx[src[o_s], pos_s] = np.asarray(payload)[o_s]
    o_r = np.argsort(dst * np.int64(ndev) + src, kind="stable")
    dsp_r = np.concatenate([[0], np.cumsum(tot_r)])
    pos_r = np.arange(M) - dsp_r[dst[o_r]]
    recv_pos = np.empty(M, np.int64)
    recv_pos[o_r] = pos_r
    recv = []
    for p in places:
        r = np.full((ndev, Cr), fill, np.int64)
        r[dst[o_r], pos_r] = np.asarray(p)[o_r]
        recv.append(r)
    return send_idx, cnt, recv, Cs, Cr, recv_pos


def _capacity(data) -> int:
    return tree_leaves(data)[0].shape[0]


def _device(data) -> torch.device:
    return tree_leaves(data)[0].device


def _count(c, device) -> torch.Tensor:
    return torch.as_tensor(c, dtype=torch.int64, device=device).reshape(())


def _key_sentinel(dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _take_rows(data, idx):
    return tree_map(lambda a: a[idx], data)


def alltoallv(comm: Comm, data, send_cnt, recv_capacity: int):
    """Ragged all-to-all (reference: Alltoallv, comm.txx:404).

    `data`: leading capacity C, rows grouped by destination rank: rows
    [dsp[r], dsp[r] + send_cnt[r]) go to rank r (dsp the exclusive
    prefix of send_cnt); rows past sum(send_cnt) are padding.  Returns
    (recv_data, recv_cnt): the rows received, packed by source rank, in
    a zero-padded buffer of `recv_capacity` rows."""
    dev = _device(data)
    send_cnt = torch.as_tensor(send_cnt, dtype=torch.int64, device=dev) \
        .reshape(-1)
    p = comm.size()
    if comm.is_self or p == 1:
        C = _capacity(data)
        n = torch.clamp(send_cnt[0], max=recv_capacity)
        idx = torch.arange(recv_capacity, device=dev) % max(C, 1)
        return _take_rows(data, idx), n
    all_cnt = comm._all_gather(send_cnt).cpu()           # (p, p) [src, dst]
    r = comm.rank()
    cnt_to_me = all_cnt[:, r]
    recv_cnt = int(cnt_to_me.sum())
    send_splits = all_cnt[r].tolist()
    n_send = sum(send_splits)

    def one(v):
        got = comm._all_to_all_v(v[:n_send], send_splits,
                                 cnt_to_me.tolist())
        out = v.new_zeros((recv_capacity,) + v.shape[1:])
        m = min(recv_cnt, recv_capacity)
        out[:m] = got[:m]
        return out

    return tree_map(one, data), torch.tensor(recv_cnt, device=dev)


def allgatherv(comm: Comm, rows: torch.Tensor,
               cap: Optional[int] = None) -> torch.Tensor:
    """Ragged all-gather (reference: Allgatherv, comm.txx:~350): each
    rank's (n_r, ...) rows -> their concatenation in rank order, on
    every rank.  The counts are all-gathered, then the rows, padded to
    `cap` rows (default the largest n_r), in one all-gather."""
    if comm.is_self or comm.size() == 1:
        return rows
    n = torch.tensor([rows.shape[0]], device=rows.device)
    cnt = comm._all_gather(n).reshape(-1).tolist()
    cap = max(cnt) if cap is None else cap
    pad = rows.new_zeros((cap,) + rows.shape[1:])
    pad[:rows.shape[0]] = rows
    g = comm._all_gather(pad)
    return torch.cat([g[q, :c] for q, c in enumerate(cnt)])


def alltoallv_ring(comm: Comm, data, send_cnt, recv_capacity: int):
    """Ragged all-to-all with O(C) staging: p - 1 ring steps rotate each
    rank's whole buffer, every rank taking the segment addressed to it
    (the EvalDirect ring shape, fmm-wrapper.txx:537).  The contract of
    `alltoallv`; only the (p, p) counts are gathered."""
    p = comm.size()
    if comm.is_self or p == 1:
        return alltoallv(comm, data, send_cnt, recv_capacity)
    dev = _device(data)
    send_cnt = torch.as_tensor(send_cnt, dtype=torch.int64, device=dev) \
        .reshape(-1)
    r = comm.rank()
    all_cnt = comm._all_gather(send_cnt)
    all_dsp = exclusive_cumsum(all_cnt, dim=1)
    cnt_to_me, dsp_to_me = all_cnt[:, r], all_dsp[:, r]
    recv_dsp = exclusive_cumsum(cnt_to_me)
    C = _capacity(data)
    j = torch.arange(recv_capacity, device=dev)
    out = tree_map(lambda v: v.new_zeros((recv_capacity,) + v.shape[1:]),
                   data)
    buf = data
    perm = [(i, (i + 1) % p) for i in range(p)]
    for s in range(p):
        src = (r - s) % p
        o0, n_seg = recv_dsp[src], cnt_to_me[src]
        take = torch.clamp(j - o0 + dsp_to_me[src], 0, C - 1)
        valid = (j >= o0) & (j < o0 + n_seg)

        def place(o, v):
            vs = valid.reshape((-1,) + (1,) * (v.dim() - 1))
            return torch.where(vs, v[take], o)

        out = tree_map(place, out, buf)
        if s < p - 1:
            buf = tree_map(lambda v: comm._ppermute(v, perm), buf)
    return out, cnt_to_me.sum()


# Above this many staged rows (p * C) `route` takes the O(C) ring in
# place of the gathered counts' single exchange, as the JAX package does.
RING_THRESHOLD_ROWS = 1 << 21


def route(comm: Comm, data, cnt, dest, recv_capacity: int,
          impl: str = "auto"):
    """Route each valid row i to rank dest[i] (the sparse Ialltoallv
    pattern, comm.txx:363), stable within (source, destination).  impl:
    "auto" (the ring when p * C exceeds RING_THRESHOLD_ROWS), "gather"
    or "ring".  Returns (recv_data, recv_cnt)."""
    p = comm.size()
    C = _capacity(data)
    dev = _device(data)
    i = torch.arange(C, device=dev)
    dest = torch.where(i < _count(cnt, dev), dest.to(torch.int64),
                       torch.full_like(i, p))
    order = torch.argsort(dest, stable=True)
    data_sorted = _take_rows(data, order)
    bounds = torch.searchsorted(dest[order],
                                torch.arange(p + 1, device=dev))
    send_cnt = torch.diff(bounds)
    ring = impl == "ring" or (impl == "auto" and p * C > RING_THRESHOLD_ROWS)
    return (alltoallv_ring if ring else alltoallv)(
        comm, data_sorted, send_cnt, recv_capacity)


def partition_n(comm: Comm, data, cnt, target_cnt, capacity: int):
    """Repartition so that rank r holds exactly target_cnt[r] rows,
    global order kept (reference: PartitionN, comm.txx:625)."""
    dev = _device(data)
    my_dsp = comm.scan(_count(cnt, dev), exclusive=True)
    gid = my_dsp + torch.arange(_capacity(data), device=dev)
    tgt_dsp = exclusive_cumsum(torch.as_tensor(target_cnt,
                                               dtype=torch.int64,
                                               device=dev))
    dest = torch.clamp(torch.searchsorted(tgt_dsp, gid, right=True) - 1, 0,
                       comm.size() - 1)
    return route(comm, data, cnt, dest, capacity)


def partition_w(comm: Comm, data, cnt, weights, capacity: int):
    """Weight-balanced repartition (reference: PartitionW, comm.txx:540):
    the global sequence split so that every rank gets about equal total
    weight, order kept."""
    p = comm.size()
    dev = _device(data)
    i = torch.arange(_capacity(data), device=dev)
    w = torch.where(i < _count(cnt, dev), weights.to(torch.float64),
                    torch.zeros((), dtype=torch.float64, device=dev))
    local_pre = torch.cumsum(w, 0) - w
    my_off = comm.scan(w.sum(), exclusive=True)
    total = comm.allreduce(w.sum())
    gpre = my_off + local_pre + 0.5 * w
    dest = torch.clamp((gpre * p / torch.clamp(total, min=1e-300))
                       .to(torch.int32), 0, p - 1)
    dest = torch.cummax(dest, 0).values
    return route(comm, data, cnt, dest, capacity)


def partition_s(comm: Comm, data, cnt, keys, splitters, capacity: int):
    """Splitter-based repartition (reference: PartitionS, comm.txx:696):
    rank r gets the keys in [splitters[r-1], splitters[r])."""
    dest = torch.searchsorted(splitters.contiguous(), keys.contiguous(),
                              right=True)
    return route(comm, data, cnt, dest, capacity)


def _local_sort_by_key(keys, cnt, payload):
    """Stable local sort of the valid rows by key; padding last."""
    i = torch.arange(keys.shape[0], device=keys.device)
    k = torch.where(i < cnt, keys,
                    torch.full_like(keys, _key_sentinel(keys.dtype)))
    order = torch.argsort(k, stable=True)
    return k[order], (None if payload is None else _take_rows(payload,
                                                              order))


def global_sort(comm: Comm, keys, cnt, payload=None,
                capacity: Optional[int] = None, rebalance: bool = True):
    """Distributed sort by key (reference: HyperQuickSort, comm.txx:1159;
    the JAX package's sample sort: local sort, regular samples, global
    splitters, route, local sort).  Returns (keys_sorted, payload_sorted,
    out_cnt): rank r's keys <= rank r+1's, each rank sorted; with
    rebalance the counts are evened by `partition_n` after."""
    p = comm.size()
    dev = keys.device
    C = keys.shape[0]
    capacity = capacity or 2 * C
    cnt = _count(cnt, dev)
    sentinel = _key_sentinel(keys.dtype)
    keys_l, payload_l = _local_sort_by_key(keys, cnt, payload)
    if comm.is_self or p == 1:
        if capacity != C:
            pad_idx = torch.arange(capacity, device=dev) % C
            keys_l = keys_l[pad_idx]
            payload_l = (None if payload is None
                         else _take_rows(payload_l, pad_idx))
        return keys_l, payload_l, cnt

    # regular samples of the sorted keys; a rank with cnt < ns gives only
    # its min(cnt, ns) keys (the rest sentinels)
    ns = min(C, 32)
    m = torch.clamp(cnt, max=ns)
    pos = ((torch.arange(ns, device=dev, dtype=torch.float64) + 0.5) * cnt
           / torch.clamp(m, min=1)).to(torch.int32)
    pos = torch.minimum(torch.clamp(pos, min=0),
                        torch.clamp(cnt - 1, min=0)).long()
    samples = torch.where(torch.arange(ns, device=dev) < m, keys_l[pos],
                          torch.full_like(keys_l[pos], sentinel))
    all_samples = torch.sort(comm._all_gather(samples).reshape(-1)).values
    n_valid = comm.allreduce(m)
    spos = torch.clamp((torch.arange(1, p, device=dev) * n_valid) // p, 0,
                       p * ns - 1)
    splitters = all_samples[spos]

    tree = {"k": keys_l}
    if payload is not None:
        tree["v"] = payload_l
    routed, out_cnt = partition_s(comm, tree, cnt, keys_l, splitters,
                                  capacity)
    keys_r = torch.where(torch.arange(capacity, device=dev) < out_cnt,
                         routed["k"], torch.full_like(routed["k"], sentinel))
    keys_s, payload_s = _local_sort_by_key(keys_r, out_cnt, routed.get("v"))
    if rebalance:
        total = comm.allreduce(out_cnt)
        tgt = torch.full((p,), int(total) // p, dtype=torch.int64,
                         device=dev)
        tgt += (torch.arange(p, device=dev) < total % p).long()
        tree2 = {"k": keys_s}
        if payload is not None:
            tree2["v"] = payload_s
        routed2, out_cnt = partition_n(comm, tree2, out_cnt, tgt, capacity)
        keys_s = torch.where(torch.arange(capacity, device=dev) < out_cnt,
                             routed2["k"],
                             torch.full_like(routed2["k"], sentinel))
        payload_s = routed2.get("v")
    return keys_s, payload_s, out_cnt


def _gather_dsp(comm: Comm, cnt, device) -> torch.Tensor:
    """(p,) exclusive prefix of the ranks' counts, the same on every
    rank."""
    if comm.is_self:
        return torch.zeros(1, dtype=torch.int64, device=device)
    return exclusive_cumsum(comm._all_gather(_count(cnt, device)))


def sort_scatter_index(comm: Comm, keys, cnt,
                       capacity: Optional[int] = None):
    """For each valid local element, its global position in the sorted
    order (reference: SortScatterIndex, comm.txx:730); feed it to
    `scatter_forward`."""
    C = keys.shape[0]
    dev = keys.device
    capacity = capacity or 2 * C
    cnt = _count(cnt, dev)
    my_dsp = comm.scan(cnt, exclusive=True)
    gid = my_dsp + torch.arange(C, device=dev)
    _, gid_s, out_cnt = global_sort(comm, keys, cnt, payload=gid,
                                    capacity=capacity, rebalance=False)
    sort_dsp = comm.scan(out_cnt, exclusive=True)
    s_pos = sort_dsp + torch.arange(capacity, device=dev)
    all_dsp = _gather_dsp(comm, cnt, dev)
    dest = torch.clamp(torch.searchsorted(all_dsp, gid_s, right=True) - 1,
                       0, comm.size() - 1)
    routed, rcnt = route(comm, {"g": gid_s, "s": s_pos}, out_cnt, dest,
                         capacity)
    scatter_idx = torch.zeros(C, dtype=torch.int64, device=dev)
    valid = torch.arange(capacity, device=dev) < rcnt
    slot = torch.clamp(routed["g"] - my_dsp, 0, C - 1)
    scatter_idx[slot[valid]] = routed["s"][valid]
    return scatter_idx


def scatter_forward(comm: Comm, data, cnt, scatter_idx,
                    out_cnt_per_rank=None, capacity: Optional[int] = None):
    """Move row i to global position scatter_idx[i] (reference:
    ScatterForward, comm.txx:811).  out_cnt_per_rank: the (p,) target
    layout, default the current one.  Returns (out_data, out_cnt)."""
    p = comm.size()
    dev = _device(data)
    C = _capacity(data)
    capacity = capacity or C
    cnt = _count(cnt, dev)
    if out_cnt_per_rank is None:
        out_cnt_per_rank = (cnt[None] if comm.is_self
                            else comm._all_gather(cnt))
    out_cnt_per_rank = torch.as_tensor(out_cnt_per_rank, dtype=torch.int64,
                                       device=dev)
    out_dsp = exclusive_cumsum(out_cnt_per_rank)
    dest = torch.clamp(torch.searchsorted(out_dsp, scatter_idx, right=True)
                       - 1, 0, p - 1)
    routed, rcnt = route(comm, {"i": scatter_idx, "d": data}, cnt, dest,
                         capacity)
    r = comm.rank()
    valid = torch.arange(capacity, device=dev) < rcnt
    slot = torch.clamp(routed["i"] - out_dsp[r], 0, capacity - 1)[valid]

    def place(v):
        out = v.new_zeros((capacity,) + v.shape[1:])
        out[slot] = v[valid]
        return out

    return tree_map(place, routed["d"]), out_cnt_per_rank[r]


def scatter_reverse(comm: Comm, data, cnt, scatter_idx, orig_cnt,
                    capacity: Optional[int] = None):
    """Inverse of `scatter_forward` (reference: ScatterReverse,
    comm.txx:936): `data` in scattered order comes back to the original
    slots that `scatter_idx` / `orig_cnt` (from sort_scatter_index)
    describe."""
    p = comm.size()
    dev = _device(data)
    C = scatter_idx.shape[0]
    capacity = capacity or _capacity(data)
    orig_cnt = _count(orig_cnt, dev)
    my_dsp = comm.scan(orig_cnt, exclusive=True)
    gid = my_dsp + torch.arange(C, device=dev)
    scat_dsp_all = _gather_dsp(comm, cnt, dev)
    dest = torch.clamp(torch.searchsorted(scat_dsp_all, scatter_idx,
                                          right=True) - 1, 0, p - 1)
    req, req_cnt = route(comm, {"g": gid, "s": scatter_idx}, orig_cnt,
                         dest, capacity)
    r = comm.rank()
    s_local = torch.clamp(req["s"] - scat_dsp_all[r], 0,
                          _capacity(data) - 1)
    vals = _take_rows(data, s_local)
    orig_dsp_all = _gather_dsp(comm, orig_cnt, dev)
    dest2 = torch.clamp(torch.searchsorted(orig_dsp_all, req["g"],
                                           right=True) - 1, 0, p - 1)
    back, back_cnt = route(comm, {"g": req["g"], "d": vals}, req_cnt, dest2,
                           capacity)
    valid = torch.arange(capacity, device=dev) < back_cnt
    slot = torch.clamp(back["g"] - my_dsp, 0, C - 1)[valid]

    def place(v):
        out = v.new_zeros((C,) + v.shape[1:])
        out[slot] = v[valid]
        return out

    return tree_map(place, back["d"]), orig_cnt
