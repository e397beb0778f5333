"""Comm: the communication layer's primitive verbs over a
`torch.distributed` process group (counterpart of sctl_tpu/comm/comm.py;
reference: include/sctl/comm.hpp:35-441, comm.txx).

The JAX package names one axis of a device mesh and traces its verbs as
XLA collectives inside one program.  The port runs one process a rank,
as the reference's MPI does, and each verb is a `torch.distributed`
call on the rank's own tensors:

  allreduce (sum, max, min)   all_reduce              (comm.txx:478)
  scan                        all_gather, then a local prefix (:509)
  bcast                       broadcast
  allgather                   all_gather_into_tensor
  alltoall                    all_to_all_single
  ppermute, send_recv_shift,  batch_isend_irecv       (comm.txx:220)
  send_recv
  barrier                     barrier

Where a JAX verb returns a sharded array, rank r returns block r of it.

`Comm()` (or `Comm.self_()`) is the self-communicator: size 1, rank 0,
every verb the identity (or its p = 1 form), outside any process group
(the reference's serial build, comm.hpp:32-33).  `Comm.world()` wraps
the caller's initialized default group, `split` sub-groups of it.

Transport: the backend is the caller's (`init_process_group`), read once
when the Comm is built.  A verb whose collective takes no CUDA tensor on
that backend (`HOST_STAGED`) copies CUDA tensors through a pinned host
buffer, always, on that backend; on every other backend and collective
the tensors go as they are.  Nothing is caught to switch transport: a
failed collective raises.

Every verb credits `profile.add_comm` as the JAX package's does
(comm.py:154-272); the verbs module's inner collectives, which the JAX
package issues as bare `lax` calls, credit nothing (`_all_gather`,
`_all_to_all_v`, `_ppermute`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .. import profile

# Collectives that take no CUDA tensor on a backend, found on the card's
# torch: gloo's point-to-point send and receive (the other collectives
# gloo runs on CUDA tensors).  NCCL takes CUDA tensors for all of them.
HOST_STAGED = {"gloo": frozenset({"p2p"})}

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def exclusive_cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Exclusive prefix sum along a dimension."""
    return torch.cumsum(x, dim=dim) - x


def tree_map(fn, x, *rest):
    """fn over the tensors of a tensor, dict, list or tuple (the JAX
    verbs' pytrees), structure kept."""
    if isinstance(x, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, *a) for a in zip(x, *rest))
    return fn(x, *rest)


def tree_leaves(x) -> list:
    if isinstance(x, dict):
        return [t for v in x.values() for t in tree_leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tree_leaves(v)]
    return [x]


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(x)
                     if isinstance(t, torch.Tensor)))


class Comm:
    """Communicator over a process group, or the self-communicator.

        comm = Comm.world()            # after init_process_group
        s = comm.allreduce(x)          # x: this rank's tensor(s)
        sub = comm.split(colors)       # colors[rank] picks the group
    """

    def __init__(self):
        self.group = None              # None: the self-communicator
        self.backend: Optional[str] = None
        self._size, self._rank = 1, 0
        self._ranks = [0]              # group rank -> global rank

    @classmethod
    def _of(cls, group) -> "Comm":
        c = cls()
        c.group = group
        c.backend = str(dist.get_backend(group))
        c._size = dist.get_world_size(group)
        c._rank = dist.get_rank(group)
        c._ranks = list(dist.get_process_group_ranks(group))
        return c

    # ---- introspection ------------------------------------------------
    @staticmethod
    def self_() -> "Comm":
        """The self-communicator (reference: Comm::Self())."""
        return Comm()

    @staticmethod
    def world(group=None) -> "Comm":
        """Communicator over `group`, default the initialized default
        group (reference: Comm::World())."""
        if not dist.is_initialized():
            raise RuntimeError("Comm.world: torch.distributed is not "
                               "initialized (init_process_group)")
        return Comm._of(dist.group.WORLD if group is None else group)

    @property
    def is_self(self) -> bool:
        return self.group is None

    def size(self) -> int:
        return self._size

    def rank(self) -> int:
        """Rank within this communicator (group-local after split)."""
        return self._rank

    def split(self, colors: Sequence[int]) -> "Comm":
        """Sub-communicator by color (reference: Comm::Split,
        comm.hpp:98): ranks with equal colors[rank] form a group, in
        rank order.  Every rank creates every group (`dist.new_group`
        is collective); groups may differ in size."""
        if self.is_self:
            raise ValueError("split: needs a process-group communicator")
        colors = [int(c) for c in colors]
        if len(colors) != self._size:
            raise ValueError(f"split: {len(colors)} colors for "
                             f"{self._size} ranks")
        mine = None
        for c in sorted(set(colors)):
            members = [self._ranks[i] for i in range(self._size)
                       if colors[i] == c]
            g = dist.new_group(members)
            if colors[self._rank] == c:
                mine = g
        return Comm._of(mine)

    # ---- transport ------------------------------------------------------
    def _stages(self, coll: str, t: torch.Tensor) -> bool:
        return t.is_cuda and coll in HOST_STAGED.get(self.backend, ())

    def _host(self, coll: str, t: torch.Tensor) -> torch.Tensor:
        """t, or a pinned host copy of it where `coll` stages."""
        if not self._stages(coll, t):
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def _recv_buf(self, coll: str, like: torch.Tensor) -> torch.Tensor:
        if self._stages(coll, like):
            return torch.empty(like.shape, dtype=like.dtype,
                               pin_memory=True)
        return torch.empty_like(like)

    # ---- primitive collectives ------------------------------------------
    def allreduce(self, x, op: str = "sum"):
        """Allreduce over the group (reference: comm.txx:478)."""
        if self.is_self:
            return x
        profile.add_comm(1, _nbytes(x))
        rop = _REDUCE_OPS[op]

        def one(v):
            out = v.clone()
            buf = self._host("all_reduce", out)
            dist.all_reduce(buf, op=rop, group=self.group)
            return out if buf is out else out.copy_(buf)

        return tree_map(one, x)

    def scan(self, x, op: str = "sum", exclusive: bool = False):
        """Prefix reduction over ranks (reference: MPI_Scan,
        comm.txx:509): all-gather, then the reduction of ranks < r
        (exclusive) or <= r."""
        if self.is_self:
            return tree_map(torch.zeros_like, x) if exclusive else x
        profile.add_comm(1, _nbytes(x))
        r = self._rank

        def one(v):
            g = self._all_gather(v)                         # (p, ...)
            idx = torch.arange(self._size, device=v.device)
            mask = ((idx < r) if exclusive else (idx <= r)).reshape(
                (self._size,) + (1,) * v.dim())
            if op == "sum":
                return (g * mask.to(g.dtype)).sum(0)
            big = {"max": -float("inf"), "min": float("inf")}[op]
            if not g.dtype.is_floating_point:
                big = (torch.iinfo(g.dtype).min if op == "max"
                       else torch.iinfo(g.dtype).max)
            masked = torch.where(mask, g, torch.full_like(g, big))
            return masked.amax(0) if op == "max" else masked.amin(0)

        return tree_map(one, x)

    def bcast(self, x, root: int = 0):
        """Broadcast from group rank `root` (reference: Comm::Bcast)."""
        if self.is_self:
            return x
        profile.add_comm(1, _nbytes(x))

        def one(v):
            out = v.clone()
            buf = self._host("broadcast", out)
            dist.broadcast(buf, src=self._ranks[root], group=self.group)
            return out if buf is out else out.copy_(buf)

        return tree_map(one, x)

    def allgather(self, x, tiled: bool = False):
        """Allgather (reference: comm.txx:~350): (p, ...) blocks, or
        with tiled=True concatenated along the leading axis."""
        if self.is_self:
            return x
        profile.add_comm(1, _nbytes(x) * self._size)
        return tree_map(lambda v: self._all_gather(v, tiled), x)

    def _all_gather(self, v: torch.Tensor, tiled: bool = False):
        """all_gather_into_tensor of one tensor, no profile credit."""
        if self.is_self:
            return v if tiled else v[None]
        v = v.contiguous()
        flat = v.reshape(1, -1) if v.dim() == 0 else v
        out = torch.empty((self._size * flat.shape[0],) + flat.shape[1:],
                          dtype=v.dtype, device=v.device)
        buf = self._host("all_gather_into_tensor", out)
        dist.all_gather_into_tensor(
            buf, self._host("all_gather_into_tensor", flat),
            group=self.group)
        if buf is not out:
            out.copy_(buf)
        if tiled and v.dim():
            return out
        return out.reshape((self._size,) + v.shape)

    def alltoall(self, x, split_axis: int = 0, concat_axis: int = 0):
        """Equal-split all-to-all (reference: comm.txx:~395): the p
        chunks of split_axis go to ranks 0..p-1, the received chunks are
        concatenated along concat_axis in source order."""
        if self.is_self:
            return x
        profile.add_comm(1, _nbytes(x))
        p = self._size

        def one(v):
            send = torch.stack(v.chunk(p, split_axis)).contiguous()
            recv = torch.empty_like(send)
            sb = self._host("all_to_all_single", send)
            rb = self._recv_buf("all_to_all_single", recv)
            dist.all_to_all_single(rb, sb, group=self.group)
            if rb is not recv:
                recv.copy_(rb)
            return torch.cat(list(recv.unbind(0)), dim=concat_axis)

        return tree_map(one, x)

    def _all_to_all_v(self, v: torch.Tensor, send_splits, recv_splits):
        """Ragged all_to_all_single of one tensor's leading rows, no
        profile credit: send_splits[d] rows go to rank d, recv_splits[s]
        rows arrive from rank s, packed by source."""
        v = v.contiguous()
        recv = torch.empty((int(sum(recv_splits)),) + v.shape[1:],
                           dtype=v.dtype, device=v.device)
        if self.is_self:
            return recv.copy_(v[:recv.shape[0]])
        sb = self._host("all_to_all_single", v)
        rb = self._recv_buf("all_to_all_single", recv)
        dist.all_to_all_single(rb, sb, output_split_sizes=list(recv_splits),
                               input_split_sizes=list(send_splits),
                               group=self.group)
        return recv if rb is recv else recv.copy_(rb)

    def _ppermute(self, v: torch.Tensor, perm: Sequence, fill=0):
        """One tensor along the (src, dst) pairs of `perm` (group ranks),
        no profile credit: the received tensor, or `fill` where none
        arrives."""
        r = self._rank
        dsts = [d for s, d in perm if s == r]
        srcs = [s for s, d in perm if d == r]
        if len(srcs) > 1:
            raise ValueError("ppermute: one message per destination")
        if srcs and srcs[0] == r:
            out = v.clone()
        else:
            out = torch.full_like(v, fill)
        ops = []
        send = None
        for d in dsts:
            if d != r:
                if send is None:
                    send = self._host("p2p", v.contiguous())
                ops.append(dist.P2POp(dist.isend, send, self._ranks[d],
                                      self.group))
        rbuf = None
        if srcs and srcs[0] != r:
            rbuf = self._recv_buf("p2p", out)
            ops.append(dist.P2POp(dist.irecv, rbuf, self._ranks[srcs[0]],
                                  self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if rbuf is not None:
            out.copy_(rbuf)
        return out

    def ppermute(self, x, perm: Sequence):
        """Point-to-point along (src, dst) pairs in group ranks; a rank
        that receives nothing gets zeros (lax.ppermute's rule)."""
        if self.is_self:
            return x
        profile.add_comm(1, _nbytes(x))
        return tree_map(lambda v: self._ppermute(v, perm), x)

    def send_recv_shift(self, x, shift: int = 1):
        """Ring shift: every rank sends to (rank + shift) % p and
        receives from (rank - shift) % p (the Isend/Irecv ring of
        EvalDirect, fmm-wrapper.txx:537-558)."""
        p = self._size
        if self.is_self or p == 1:
            return x
        return self.ppermute(x, [(i, (i + shift) % p) for i in range(p)])

    def send_recv(self, x, pairs: Sequence, fill=0):
        """Tag-free point-to-point exchange (reference: Isend/Irecv/Wait,
        comm.hpp:130-147): each src's x arrives at its dst, ranks that
        receive nothing get `fill`.  One message per destination."""
        if self.is_self:
            return x
        dsts = [d for _, d in pairs]
        if len(set(dsts)) != len(dsts):
            raise ValueError("send_recv: one message per destination "
                             "per call")
        profile.add_comm(len(pairs), _nbytes(x))
        return tree_map(lambda v: self._ppermute(v, pairs, fill), x)

    def barrier(self):
        """Wait for every rank of the group."""
        if not self.is_self:
            dist.barrier(group=self.group)
