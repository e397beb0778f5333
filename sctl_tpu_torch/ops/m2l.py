"""The V-list (M2L) kernels of the uniform grid (counterpart of
sctl_tpu/ops/pallas_m2l.py).

`m2l_grid` (`m2l_grid` :109-224, host helpers :359-388): the 316-offset
sweep over the V-projected grid (n+6, n+6, n+6, r2) with 3-wide zero
margins.  Box b of child parity c = 4(x%2) + 2(y%2) + z%2 sums exactly
its 189 valid offsets d (`parity_offsets`), the products
qp[b + 3 + d] @ A_d^T.  The TPU kernel runs all 316 and masks the
others to zero; here each parity's targets are one matrix product over
their own offsets.

`m2l_grid_blocked` (:227-303, host helpers :306-356): the child grid
(n, n, n, r2) is reshaped to the parent grid (h, h, h, 8*r2), h = n/2,
child channel blocks c = 4cx + 2cy + cz, and swept with the 26
parent-neighbour directions; direction k applies one (8*r2, 8*r) block
operator assembled from the child-pair V-list tables, near child pairs
zero.

On a CUDA tensor `m2l_grid` launches csrc/m2l_grid.cu and
`m2l_grid_blocked` csrc/m2l_blocked.cu, both on the tensor-core engine
of csrc/m2l_tc.cuh (3xTF32: each f32 operand split into TF32 hi and lo
parts, the products lo hi + hi lo + hi hi summed in f32); on a CPU
tensor each runs its plain version.  The kernels take their operator
stack split once (`tf32x3_operands`, built at setup by
`KIFMMOperators`); `m2l_grid_tf32x3` and `m2l_grid_blocked_tf32x3`
repeat the split's arithmetic in plain PyTorch for the tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ._build import launch
from ._launch_checks import check_kernel_args, n_sms, on_cuda


def vlist_offsets():
    """The 316 same-level offsets d with |d|_inf in {2, 3} and the
    (8 parities, 316) table: d is in the V list of a child of parity c
    (c = 4x + 2y + z) iff the parents are neighbours,
    |floor((c + d) / 2)|_inf <= 1."""
    rng = np.arange(-3, 4)
    d = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                 -1).reshape(-1, 3)
    d = d[np.abs(d).max(axis=1) >= 2]
    par = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                   -1).reshape(-1, 3)
    pd = np.floor((par[:, None, :] + d[None, :, :]) / 2).astype(int)
    return d, np.abs(pd).max(axis=2) <= 1


# valid offsets of each child parity (189 of the 316)
N_VALID = 189


@functools.lru_cache(maxsize=None)
def parity_offsets() -> np.ndarray:
    """(8, 189, 4) int32, read-only: for child parity c = 4(x%2) +
    2(y%2) + z%2, its valid offsets (dx, dy, dz) and their index o in
    `vlist_offsets` order, ascending in o.  The same validity as the TPU
    kernel's (316, t, t, n) masks (pallas_m2l.py `_full_masks`), as
    lists."""
    d, valid = vlist_offsets()
    tab = np.zeros((8, N_VALID, 4), np.int32)
    for c in range(8):
        oi = np.nonzero(valid[c])[0]
        tab[c, :, :3] = d[oi]
        tab[c, :, 3] = oi
    tab.setflags(write=False)
    return tab


@functools.lru_cache(maxsize=None)
def _parity_offsets_on(device: torch.device) -> torch.Tensor:
    return torch.tensor(parity_offsets(), device=device)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero, as
    cvt.rna.tf32.f32), by integer rounding of the bits: the low 13
    mantissa bits zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """float32 x -> (hi, lo), TF32 both, hi = tf32_round(x) and lo =
    tf32_round(x - hi): |x - hi - lo| <= 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3_operands(mats_k: torch.Tensor) -> torch.Tensor:
    """K-major operator stack (n_ops, N, K) float32 -> (2, n_ops, N, K):
    its TF32 hi and lo parts, the B operand of the tensor-core kernels.
    Built once per stack (KIFMMOperators does it at setup)."""
    return torch.stack(tf32_split(mats_k.contiguous()))


def _tf32x3(plain, qp, mats):
    """The kernels' arithmetic in plain PyTorch: both operands split
    into TF32 hi and lo parts, the three products lo hi, hi lo, hi hi
    each summed in f32 by `plain`, added smallest first."""
    qh, ql = tf32_split(qp)
    mh, ml = tf32_split(mats)
    return plain(ql, mh) + plain(qh, ml) + plain(qh, mh)


# The engine's tiles (csrc/m2l_tc.cuh BM, BK; the kernels' BN).
TC_BM, TC_BK = 128, 32
BLOCKED_BN, GRID_BN = 144, 80
# A block sums at most this many (K slice, shift) steps, each added to
# its f32 sum once: longer sums lose accuracy (csrc/m2l_tc.cuh); and at
# least _MIN_STEPS, so that its pipeline fills.
_MAX_STEPS, _MIN_STEPS = 256, 8


def _splits(device, tiles: int, steps: int, nsplit=None):
    """(nsplit, chunk) of a launch of `tiles` output tiles whose K
    range is `steps` (K slice, shift) steps: split s sums the steps
    [s chunk, (s+1) chunk).  By default enough splits for two blocks an
    SM and for at most _MAX_STEPS steps a block, none under
    _MIN_STEPS; `nsplit` asks for a count."""
    if nsplit is None:
        nsplit = max(-(-2 * n_sms(device) // tiles),
                     -(-steps // _MAX_STEPS))
        nsplit = min(nsplit, max(1, steps // _MIN_STEPS))
    chunk = -(-steps // max(1, min(nsplit, steps)))
    return -(-steps // chunk), chunk


def m2l_grid_plain(qp, mats_t):
    """Plain version of `m2l_grid`: per parity, one (h^3, r2) @ (r2, r)
    product for each of its 189 offsets, added in order."""
    n = qp.shape[0] - 6
    h = n // 2
    out = qp.new_empty((n, n, n, mats_t.shape[-1]))
    for c, offs in enumerate(parity_offsets()):
        cx, cy, cz = (c >> 2) & 1, (c >> 1) & 1, c & 1
        acc = None
        for dx, dy, dz, o in offs.tolist():
            x0, y0, z0 = 3 + cx + dx, 3 + cy + dy, 3 + cz + dz
            win = qp[x0:x0 + n:2, y0:y0 + n:2, z0:z0 + n:2]
            y = win.reshape(h ** 3, -1) @ mats_t[o]
            acc = y if acc is None else acc + y
        out[cx::2, cy::2, cz::2] = acc.reshape(h, h, h, -1)
    return out


def m2l_grid_tf32x3(qp, mats_t):
    """`m2l_grid`'s kernel arithmetic (3xTF32) in plain PyTorch."""
    return _tf32x3(m2l_grid_plain, qp, mats_t)


def grid_operands(mats_t: torch.Tensor) -> torch.Tensor:
    """(316, r2, r) stack of `m2l_grid` -> its kernel operand (2, 316,
    r', r2'): A_o = mats_t[o]^T, K-major, split into TF32 hi and lo,
    r2 padded to a multiple of 4 and r to a multiple of 2 (the kernel's
    16- and 8-byte accesses)."""
    r2, r = mats_t.shape[-2:]
    return tf32x3_operands(F.pad(mats_t.transpose(1, 2),
                                 (0, -r2 % 4, 0, r % 2)))


def m2l_grid(qp, mats_t, mats_tc=None, nsplit=None):
    """qp (n+6, n+6, n+6, r2): the V-projected grid with 3-wide zero
    margins; mats_t (316, r2, r): A_d^T in `vlist_offsets()` order ->
    (n, n, n, r) in raster order: out[b] = sum over the 189 offsets d
    valid for b's parity of qp[b + 3 + d] @ mats_t[d].  float32 on the
    card, where mats_tc is mats_t's kernel operand (`grid_operands`;
    built here when not given); the card's grid splits the offsets'
    K range into partial sums (`_splits`; `nsplit` asks for a count),
    added here."""
    n = qp.shape[0] - 6
    r2, r = mats_t.shape[-2:]
    if (n < 2 or n % 2 or qp.shape != (n + 6,) * 3 + (r2,)
            or mats_t.shape != (316, r2, r)):
        raise ValueError(f"m2l_grid: qp {tuple(qp.shape)}, mats_t "
                         f"{tuple(mats_t.shape)}")
    if not on_cuda(qp, mats_t):
        return m2l_grid_plain(qp, mats_t)
    if mats_tc is None:
        mats_tc = grid_operands(mats_t)
    check_kernel_args("m2l_grid", qp=qp, mats_t=mats_t, mats_tc=mats_tc)
    k4, r_even = r2 + -r2 % 4, r + r % 2
    if mats_tc.shape != (2, 316, r_even, k4):
        raise ValueError(f"m2l_grid: mats_tc {tuple(mats_tc.shape)} for "
                         f"mats_t {tuple(mats_t.shape)}")
    if k4 != r2:
        qp = F.pad(qp, (0, k4 - r2))
    tiles = 8 * -(-(n // 2) ** 3 // TC_BM) * -(-r_even // GRID_BN)
    ns, chunk = _splits(qp.device, tiles, N_VALID * -(-k4 // TC_BK),
                        nsplit)
    part = torch.empty((ns, n, n, n, r_even), dtype=torch.float32,
                       device=qp.device)
    launch("sctl_m2l_grid", qp.data_ptr(), mats_tc.data_ptr(),
           _parity_offsets_on(qp.device).data_ptr(), part.data_ptr(), n,
           k4, r_even, ns, chunk)
    m2l_grid.launches += 1
    m2l_grid.last_nsplit = ns
    out = part[0] if ns == 1 else part.sum(0)
    return out if r_even == r else out[..., :r].contiguous()


m2l_grid.launches = 0
m2l_grid.last_nsplit = 0


@functools.lru_cache(maxsize=None)
def _blk_dirs() -> np.ndarray:
    """(26, 3) parent-neighbour directions in the JAX package's order
    (dz-major stable sort); `blocked_m2l_mats` follows it."""
    dirs = np.array([(dx, dy, dz) for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1) for dz in (-1, 0, 1)
                     if (dx, dy, dz) != (0, 0, 0)])
    return dirs[np.argsort(dirs[:, 2], kind="stable")]


@functools.lru_cache(maxsize=None)
def _blk_dirs_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_blk_dirs().astype(np.int32), device=device)


def blocked_m2l_mats(ca: np.ndarray, offsets: np.ndarray,
                     valid: np.ndarray, r_cap: int,
                     r2_cap: int) -> np.ndarray:
    """(26, 8*r2_cap, 8*r_cap) sibling-blocked operator stack from the
    compressed per-offset tables ca (316, r, r2), in `_blk_dirs()`
    order.  Block (cs, ct) of direction D is A_o^T for the child offset
    d = 2D + cs - ct when (o, parity ct) is in the V list, else zero."""
    omap = {tuple(d): i for i, d in enumerate(offsets)}
    r2c, rc = r2_cap, r_cap
    W = np.zeros((26, 8 * r2c, 8 * rc), ca.dtype)
    for k, D in enumerate(_blk_dirs()):
        for ct in range(8):
            tx, ty, tz = (ct >> 2) & 1, (ct >> 1) & 1, ct & 1
            for cs in range(8):
                sx, sy, sz = (cs >> 2) & 1, (cs >> 1) & 1, cs & 1
                d = (2 * D[0] + sx - tx, 2 * D[1] + sy - ty,
                     2 * D[2] + sz - tz)
                o = omap.get(d)
                if o is None or not valid[ct, o]:
                    continue
                W[k, cs * r2c:(cs + 1) * r2c, ct * rc:(ct + 1) * rc] \
                    = ca[o, :rc, :r2c].T
    return W


def m2l_windows(qp: torch.Tensor) -> list:
    """The 26 shifted (h^3, K) windows of the padded parent grid
    qp (h+2, h+2, h+2, K), in `_blk_dirs()` order."""
    h, K = qp.shape[0] - 2, qp.shape[-1]
    return [qp[1 + dx:1 + dx + h, 1 + dy:1 + dy + h,
               1 + dz:1 + dz + h].reshape(h ** 3, K)
            for dx, dy, dz in _blk_dirs()]


def m2l_grid_blocked_plain(qp, mats_blk):
    """Plain version of `m2l_grid_blocked`: 26 window products."""
    h = qp.shape[0] - 2
    out = None
    for k, win in enumerate(m2l_windows(qp)):
        y = win @ mats_blk[k]
        out = y if out is None else out + y
    return out.reshape(h, h, h, -1)


def m2l_grid_blocked_tf32x3(qp, mats_blk):
    """`m2l_grid_blocked`'s kernel arithmetic (3xTF32) in plain
    PyTorch."""
    return _tf32x3(m2l_grid_blocked_plain, qp, mats_blk)


def blocked_operands(mats_blk: torch.Tensor) -> torch.Tensor:
    """(26, K, N) stack of `m2l_grid_blocked` -> its kernel operand
    (2, 26, N, K): the stack K-major, split into TF32 hi and lo."""
    return tf32x3_operands(mats_blk.transpose(1, 2))


def m2l_grid_blocked(qp, mats_blk, mats_tc=None, nsplit=None):
    """qp (h+2, h+2, h+2, 8*r2) zero-margin parent grid; mats_blk
    (26, 8*r2, 8*r) in `_blk_dirs()` order -> (h, h, h, 8*r)
    parent-blocked down-check contributions.  float32 on the card,
    where mats_tc is mats_blk's kernel operand (`blocked_operands`;
    built here when not given); the card's grid splits the directions'
    K range into partial sums (`_splits`; `nsplit` asks for a count),
    added here."""
    h, K = qp.shape[0] - 2, qp.shape[-1]
    N = mats_blk.shape[-1]
    if (h < 1 or qp.shape != (h + 2,) * 3 + (K,)
            or mats_blk.shape != (26, K, N) or K % 8 or N % 8):
        raise ValueError(f"m2l_grid_blocked: qp {tuple(qp.shape)}, "
                         f"mats_blk {tuple(mats_blk.shape)}")
    if not on_cuda(qp, mats_blk):
        return m2l_grid_blocked_plain(qp, mats_blk)
    if mats_tc is None:
        mats_tc = blocked_operands(mats_blk)
    check_kernel_args("m2l_grid_blocked", qp=qp, mats_blk=mats_blk,
                      mats_tc=mats_tc)
    if mats_tc.shape != (2, 26, N, K):
        raise ValueError(f"m2l_grid_blocked: mats_tc "
                         f"{tuple(mats_tc.shape)} for mats_blk "
                         f"{tuple(mats_blk.shape)}")
    tiles = -(-h ** 3 // TC_BM) * -(-N // BLOCKED_BN)
    ns, chunk = _splits(qp.device, tiles, 26 * -(-K // TC_BK), nsplit)
    part = torch.empty((ns, h, h, h, N), dtype=torch.float32,
                       device=qp.device)
    launch("sctl_m2l_grid_blocked", qp.data_ptr(), mats_tc.data_ptr(),
           _blk_dirs_on(qp.device).data_ptr(), part.data_ptr(), h, K, N,
           ns, chunk)
    m2l_grid_blocked.launches += 1
    m2l_grid_blocked.last_nsplit = ns
    return part[0] if ns == 1 else part.sum(0)


m2l_grid_blocked.launches = 0
m2l_grid_blocked.last_nsplit = 0
