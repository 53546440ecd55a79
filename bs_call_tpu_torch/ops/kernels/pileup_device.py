"""The fused exact tier: the pileup of a read batch and the genotype
model on it, K12 (`csrc/pileup_genotype.cu`) on the card and its plain
PyTorch version (`device_pileup_plain` then `call_genotypes_pileup_plain`)
on the CPU, with the emit fields (K3) after it.

Counterpart of `bs_call_tpu/ops/kernels/pileup_device.py` (the pileup
:37, `_agg_quals_f32`, `fused_pileup_call`, `fused_ll_dd`,
`sharded_fused_ll_dd` :156, `pad_read_batch`) and of
`emit_device.fused_ll_emit`. The normalised read
batch of a block crosses to the device once; the pileup, the quality
rounding, the genotype model and (with the emit tier) the emit fields run
there, and only the call planes, the uint8 quals and the packed fields
come back.

K12 takes its rows sorted by start, with a table of the rows that meet
each tile of TILE positions. The engine's batches come so from the host
(`pad_read_batch`, `tile_rows`); `fused_pileup_call` takes any batch, as
the JAX function does, and `prepare_batch` sorts and pads it on its own
device.

Read batch layout (as in the JAX package):
    rd      [R, L] uint8   (base & 3 | qual << 2), 0-padded
    starts  [R]    int32   block-relative ref position of byte 0
    ori     [R]    int32   orientation row (0/1)
    strand  [R]    int32   bisulfite strand code (0/1/2)
    mapq    [R]    int32
Padding rows are all-zero bytes or lie outside [0, n_pos) (the JAX
package's padding rows carry starts < 0): they add to no position.
"""

from __future__ import annotations

import numpy as np
import torch

from bs_call_tpu_torch.constants import BASE_TAB_ST, FLT_QUAL
from bs_call_tpu_torch.ops.emit_tables import EmitTables
from bs_call_tpu_torch.ops.genotype import call_genotypes_pileup_plain
from bs_call_tpu_torch.ops.kernels.emit_device import emit_fields
from bs_call_tpu_torch.ops.kernels.pileup_genotype_cuda import (
    MAX_L,
    MIN_L,
    TILE,
    pileup_genotype,
)
from bs_call_tpu_torch.ops.params import ModelTables
from bs_call_tpu_torch.parallel.sharding import gather, slabs


def device_pileup_plain(rd, starts, ori, strand, mapq, n_pos: int,
                        min_qual: int):
    """Plain version of K12's pileup (`bs_call_tpu/ops/kernels/
    pileup_device.py:37`): the segment sums in integers, with invalid
    bytes sent to a dump segment past the end (as the JAX version does).
    Any row order. Returns (counts2 [P,2,8] i32, qual_sum [P,8] f32,
    mapq2_sum [P] f32)."""
    dev = rd.device
    R, L = rd.shape
    if R == 0 or L == 0:
        return (
            torch.zeros((n_pos, 2, 8), dtype=torch.int32, device=dev),
            torch.zeros((n_pos, 8), dtype=torch.float32, device=dev),
            torch.zeros(n_pos, dtype=torch.float32, device=dev),
        )
    x = rd.to(torch.int64)
    q = x >> 2
    tab = torch.as_tensor(BASE_TAB_ST, dtype=torch.int64, device=dev)
    cat = tab[strand.long().clamp(0, 2)[:, None], x & 3]
    j = torch.arange(L, device=dev)[None, :]
    pos = starts.long()[:, None] + j
    live = (q > 0) & (q != FLT_QUAL)
    lo = torch.where(live, j, L).amin(dim=1, keepdim=True)
    hi = torch.where(live, j, -1).amax(dim=1, keepdim=True)
    valid = (
        (j >= lo) & (j <= hi) & (q >= min_qual) & (q != FLT_QUAL)
        & (pos >= 0) & (pos < n_pos)
    )
    o = (ori != 0).long()[:, None]
    seg16 = torch.where(valid, pos * 16 + o * 8 + cat, n_pos * 16)
    counts2 = torch.zeros(n_pos * 16 + 1, dtype=torch.int32, device=dev)
    counts2.index_add_(
        0, seg16.reshape(-1), valid.to(torch.int32).reshape(-1)
    )
    seg8 = torch.where(valid, pos * 8 + cat, n_pos * 8)
    qual_sum = torch.zeros(n_pos * 8 + 1, dtype=torch.int32, device=dev)
    qual_sum.index_add_(
        0, seg8.reshape(-1), torch.where(valid, q, 0).to(torch.int32)
        .reshape(-1),
    )
    segp = torch.where(valid, pos, n_pos)
    mq2 = (mapq.long() * mapq.long())[:, None] * valid
    mapq2_sum = torch.zeros(n_pos + 1, dtype=torch.int64, device=dev)
    mapq2_sum.index_add_(0, segp.reshape(-1), mq2.reshape(-1))
    return (
        counts2[:-1].view(n_pos, 2, 8),
        qual_sum[:-1].view(n_pos, 8).to(torch.float32),
        mapq2_sum[:-1].to(torch.float32),
    )


def prepare_batch(rd, starts, ori, strand, mapq, n_pos: int):
    """K12's batch from any read batch, on the batch's device with no host
    round trip: the rows that meet [0, n_pos) sorted by start (stable)
    ahead of the rest, the rows zero-padded to L' = the width rounded up to
    a multiple of 16, at least MIN_L, in a fresh contiguous tensor, and the
    tile table of `tile_rows` over the rows that meet [0, n_pos) at width
    L'. Zero bytes are never live, so the padding adds to no position; the
    rows outside [0, n_pos) land in no tile. Returns ((rd [R, L'] u8,
    starts, ori, strand, mapq [R] i32), tiles [ceil(n_pos / TILE), 2]
    i32)."""
    if rd.dim() != 2:
        raise ValueError(f"rd: expected [R, L], got {tuple(rd.shape)}")
    R, L = rd.shape
    if L > MAX_L:
        raise ValueError(f"rd: rows of {L} bytes; K12 takes up to {MAX_L}")
    if n_pos <= 0:
        raise ValueError(f"n_pos out of range: {n_pos}")
    l_cap = max(MIN_L, -(-L // 16) * 16)
    s = starts.long()
    meets = (s <= n_pos - 1) & (s + L - 1 >= 0)
    # past every tile's last row: n_tiles * TILE < n_pos + TILE
    key, order = torch.sort(torch.where(meets, s, n_pos + TILE), stable=True)
    rows = rd.index_select(0, order)
    if l_cap != L:
        rows = torch.nn.functional.pad(rows, (0, l_cap - L))
    cols = [a.index_select(0, order).to(torch.int32)
            for a in (starts, ori, strand, mapq)]
    t0 = torch.arange(0, n_pos, TILE, dtype=torch.int64, device=rd.device)
    tiles = torch.stack([
        torch.searchsorted(key, t0 - l_cap, right=True),
        torch.searchsorted(key, t0 + TILE),
    ], dim=1).to(torch.int32)
    return (rows, *cols), tiles


def fused_pileup_call(rd, starts, ori, strand, mapq, ref, n_pos: int,
                      min_qual: int, tables: ModelTables):
    """Read batch -> pileup -> f32 quality rounding -> genotype model in
    `tables.dtype` (f32 or f64), in order on the current stream with no
    host round trip: `prepare_batch`, then K12 in one launch for a CUDA
    batch, `device_pileup_plain` then `call_genotypes_pileup_plain` for a
    CPU batch. Any batch: rows in any order, of any width up to MAX_L.
    ref [n_pos] int32. Returns (gt_prob [P,10], max_gt [P] i32, margin
    [P], off_sum [P], counts2 [P,2,8] i32, qual_sum [P,8] f32, mapq2_sum
    [P] f32), the JAX function's outputs. mapq2_sum is summed exactly and
    cast once; the JAX function's ordered f32 sum equals it below 2^24."""
    c2, qs, m2, gp, mx, mg, off, _q = _pileup_model(
        rd, starts, ori, strand, mapq, ref, n_pos, min_qual, tables, None
    )
    return gp, mx, mg, off, c2, qs, m2


def _pileup_model(rd, starts, ori, strand, mapq, ref, n_pos, min_qual,
                  tables, tiles):
    """(counts2, qual_sum, mapq2_sum, gt_prob, max_gt, margin, off_sum,
    quals_u8): K12 for a CUDA batch, the plain pileup and model for a CPU
    batch. Without `tiles` the batch goes through `prepare_batch` first;
    with them it is K12's batch already (rows sorted by start, the table
    of `tile_rows`)."""
    kind = rd.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no fused-tier kernel for device {rd.device}")
    if tiles is None:
        (rd, starts, ori, strand, mapq), tiles = prepare_batch(
            rd, starts, ori, strand, mapq, n_pos
        )
    if kind == "cpu":
        counts2, qual_sum, mapq2_sum = device_pileup_plain(
            rd, starts, ori, strand, mapq, n_pos, min_qual
        )
        return (counts2, qual_sum, mapq2_sum,
                *call_genotypes_pileup_plain(counts2, qual_sum, ref, tables))
    return pileup_genotype(rd, starts, ori, strand, mapq, tiles, ref, n_pos,
                           min_qual, tables)


def fused_ll_f64(rd, starts, ori, strand, mapq, ref, n_pos: int,
                 min_qual: int, tables: ModelTables, tiles=None):
    """Fused exact tier: read batch -> pileup -> f32 quality rounding +
    f64 genotype model + finish, in order on the current stream with no
    host round-trip: K12 in one launch for a CUDA batch, the plain
    versions for a CPU batch. With `tiles` (from `tile_rows`) the batch is
    K12's already (`pad_read_batch`); without, `prepare_batch` makes it.
    ref [n_pos] int32. Returns (gt_prob [P,10] f64, max_gt [P] i32, margin
    [P] f64, off_sum [P] f64, quals_u8 [P,8])."""
    return _fused(rd, starts, ori, strand, mapq, ref, n_pos, min_qual,
                  tables, tiles)[2]


def _require_f64(tables: ModelTables):
    if tables.dtype != torch.float64:
        raise ValueError(
            f"the fused tier needs float64 tables: {tables.dtype}"
        )


def _fused(rd, starts, ori, strand, mapq, ref, n_pos, min_qual, tables,
           tiles):
    """(counts2, mapq2_sum, (gt_prob, max_gt, margin, off_sum, quals_u8))"""
    _require_f64(tables)
    counts2, _qual_sum, mapq2_sum, *out = _pileup_model(
        rd, starts, ori, strand, mapq, ref, n_pos, min_qual, tables, tiles
    )
    return counts2, mapq2_sum, tuple(out)


def fused_ll_emit(rd, starts, ori, strand, mapq, ref, n_pos: int,
                  min_qual: int, tables: ModelTables, emit: EmitTables,
                  quirk: bool = True, tiles=None):
    """The emit tier: `fused_ll_f64`'s outputs plus the chunk's packed
    emit fields (`emit_device.unpack_fields`), K12 -> K3 in order on the
    current stream with no host round-trip (the plain versions for a
    CPU batch). Returns (gt_prob, max_gt, margin, off_sum, quals_u8,
    packed uint8 [n_pos * ROW_BYTES])."""
    counts2, mapq2_sum, out = _fused(
        rd, starts, ori, strand, mapq, ref, n_pos, min_qual, tables, tiles
    )
    packed = emit_fields(*out[:4], counts2, mapq2_sum, ref, emit, quirk)
    return (*out, packed)


def slab_batches(devices, rd, starts, ori, strand, mapq, ref, n_pos: int,
                 tiles=None):
    """K12's batch of each slab of the mesh (`parallel/sharding.py`): the
    chunk's positions cut into `slabs` of whole tiles, one per device, and
    for each the rows its tiles name in the tile table, their starts
    shifted to the slab's first position, the table's rows shifted to the
    first of them, and the slab's ref. K12 trims the bytes of a row that
    reaches in from before the slab or out past it, as it trims them at
    the chunk's ends, so a slab's outputs are the whole chunk's rows bit
    for bit.

    The batch may lie on any device (the engine's on the host, so that each
    device copies only its rows); with `tiles` (the host table of
    `tile_rows`) it is K12's batch already, without it `prepare_batch`
    makes it on the batch's device and the table comes to the host once.
    Returns per slab, on its device, ((rd, starts, ori, strand, mapq), ref,
    n_pos, tiles)."""
    if n_pos <= 0:
        raise ValueError(f"n_pos out of range: {n_pos}")
    if tiles is None:
        (rd, starts, ori, strand, mapq), tiles = prepare_batch(
            rd, starts, ori, strand, mapq, n_pos
        )
    if isinstance(tiles, torch.Tensor):
        tiles = tiles.cpu().numpy()
    out = []
    for (lo, hi), dev in zip(slabs(n_pos, len(devices)), devices):
        t0, t1 = lo // TILE, -(-hi // TILE)
        r0, r1 = int(tiles[t0, 0]), int(tiles[t1 - 1, 1])
        rows = tuple(a[r0:r1].to(dev, non_blocking=True)
                     for a in (rd, starts - lo, ori, strand, mapq))
        out.append((rows, ref[lo:hi].to(dev, non_blocking=True), hi - lo,
                    torch.from_numpy(tiles[t0:t1] - r0).to(dev)))
    return out


def slab_pileup_model(devices, rd, starts, ori, strand, mapq, ref,
                      n_pos: int, min_qual: int, tables, tiles=None):
    """The fused tier's pileup and f64 model over the mesh: on each
    device K12 (its plain version on the CPU) over its slab's batch
    (`slab_batches`). tables: each device's f64 ModelTables. Returns per
    slab, on its device, (counts2, qual_sum, mapq2_sum, gt_prob, max_gt,
    margin, off_sum, quals_u8, ref)."""
    for t in tables:
        _require_f64(t)
    return [(*_pileup_model(*rows, slab_ref, n, min_qual, tab, slab_tiles),
             slab_ref)
            for (rows, slab_ref, n, slab_tiles), tab in zip(
                slab_batches(devices, rd, starts, ori, strand, mapq, ref,
                             n_pos, tiles), tables)]


def sharded_fused_ll_f64(devices, rd, starts, ori, strand, mapq, ref,
                         n_pos: int, min_qual: int, tables, tiles=None):
    """`fused_ll_f64` over the mesh (the counterpart of
    `sharded_fused_ll_dd`): `slab_pileup_model`, the slabs' outputs
    gathered on the first device. Returns (gt_prob, max_gt, margin,
    off_sum, quals_u8), bit for bit `fused_ll_f64`'s on one device."""
    outs = slab_pileup_model(devices, rd, starts, ori, strand, mapq, ref,
                             n_pos, min_qual, tables, tiles)
    return tuple(gather([o[j] for o in outs], devices[0])
                 for j in (3, 4, 5, 6, 7))


def tile_rows(starts, n_rows: int, n_pos: int, l_cap: int):
    """K12's tile table: int32 [ceil(n_pos / TILE), 2], for each tile of
    TILE positions the first row and one past the last row whose span
    [start, start + l_cap) meets it. `starts` are a padded batch's, whose
    first n_rows are live and sorted (`pad_read_batch`)."""
    live = np.asarray(starts[:n_rows], dtype=np.int64)
    t0 = np.arange(0, n_pos, TILE, dtype=np.int64)
    out = np.empty((len(t0), 2), np.int32)
    out[:, 0] = np.searchsorted(live, t0 - l_cap, side="right")
    out[:, 1] = np.searchsorted(live, t0 + TILE, side="left")
    return out


def _rows_in(reads: dict, lo: int, hi: int):
    """The rows of a read batch that can touch positions [lo, hi], sorted
    by start (stable)."""
    starts = reads["starts"]
    keep = np.nonzero((starts <= hi) & (starts + reads["lens"] - 1 >= lo))[0]
    return keep[np.argsort(starts[keep], kind="stable")]


def _fill_batch(parts, r_pad: int, l_cap: int):
    """The (r_pad, l_cap) batch of parts [(reads, rows, shift)]: each
    part's rows in turn, their starts plus shift, zero padding after."""
    rd = np.zeros((r_pad, l_cap), np.uint8)
    cols = [np.zeros(r_pad, np.int32) for _ in range(4)]
    i = 0
    for reads, rows, shift in parts:
        j = i + len(rows)
        rd[i:j, :reads["rd"].shape[1]] = reads["rd"][rows]
        cols[0][i:j] = reads["starts"][rows] + shift
        for a, k in zip(cols[1:], ("ori", "strand", "mapq")):
            a[i:j] = reads[k][rows]
        i = j
    return (rd, *cols)


def pad_read_batch(reads: dict, lo: int, hi: int, r_pad: int, l_cap: int):
    """Slice a block's read batch to the rows that can touch positions
    [lo, hi] (block-relative), sort them by start (stable), shift starts
    to lo, and pad to the fixed (r_pad, l_cap) device shape. Returns (rd,
    starts, ori, strand, mapq) or None when the live rows exceed r_pad /
    l_cap (caller falls back). The pileup sums are integers, so the order
    of the rows changes no bit; K12 needs it to find a tile's rows
    (`tile_rows`). Padding rows are all-zero bytes: q==0 is never live, so
    they contribute to no segment regardless of their start."""
    keep = _rows_in(reads, lo, hi)
    if len(keep) > r_pad or reads["rd"].shape[1] > l_cap:
        return None
    return _fill_batch([(reads, keep, -lo)], r_pad, l_cap)


def pack_read_batch(parts, l_cap: int):
    """Several blocks' read batches as one chunk's: parts [(reads, lo,
    hi, off)], each block's window [lo, hi] placed at chunk position off.
    Each part's rows as `pad_read_batch` keeps them, their starts shifted
    to off, the parts in turn; rows padded to a power of two of at least
    1024, width to l_cap (at least every part's). With parts in order of
    off, far enough apart that no part's rows start past the next part's
    (`TorchCallEngine.pack_offsets`), the live rows stay sorted by start.
    Returns ((rd, starts, ori, strand, mapq), live rows)."""
    rows = [_rows_in(reads, lo, hi) for reads, lo, hi, _off in parts]
    n = sum(map(len, rows))
    r_pad = 1024
    while r_pad < n:
        r_pad *= 2
    return _fill_batch([(reads, keep, off - lo) for (reads, lo, _hi, off), keep
                        in zip(parts, rows)], r_pad, l_cap), n
