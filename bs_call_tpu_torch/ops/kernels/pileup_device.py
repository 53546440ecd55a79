"""K1, the pileup scatter of `csrc/pileup.cu`, its plain PyTorch version,
and the fused exact tier: `fused_ll_f64` (K1 -> K2's pileup entry) and
`fused_ll_emit` (K1 -> K2 -> K3, the emit tier).

Counterpart of `bs_call_tpu/ops/kernels/pileup_device.py`
(`device_pileup`, `_agg_quals_f32`, `fused_ll_dd`, `pad_read_batch`) and
of `emit_device.fused_ll_emit`. The normalised read batch of a block
crosses to the device once; the pileup, the quality rounding, the f64
genotype model and (with the emit tier) the emit fields run there, and
only the call planes, the uint8 quals and the packed fields come back.

Read batch layout (as in the JAX package):
    rd      [R, L] uint8   (base & 3 | qual << 2), 0-padded
    starts  [R]    int32   block-relative ref position of byte 0
    ori     [R]    int32   orientation row (0/1)
    strand  [R]    int32   bisulfite strand code (0/1/2)
    mapq    [R]    int32
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bs_call_tpu.constants import BASE_TAB_ST, FLT_QUAL
from bs_call_tpu_torch.ops.emit_tables import EmitTables
from bs_call_tpu_torch.ops.genotype import call_genotypes_pileup
from bs_call_tpu_torch.ops.kernels import _build
from bs_call_tpu_torch.ops.kernels.emit_device import emit_fields
from bs_call_tpu_torch.ops.kernels.genotype_cuda import check_rc, require
from bs_call_tpu_torch.ops.params import ModelTables

_P = ctypes.c_void_p
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load()
        i = ctypes.c_int
        lib.bsct_pileup_scatter.argtypes = [
            _P, _P, _P, _P, _P, i, i, i, i, _P, _P, _P, _P,
        ]
        lib.bsct_pileup_scatter.restype = ctypes.c_int
        _lib = lib
    return _lib


def device_pileup_plain(rd, starts, ori, strand, mapq, n_pos: int,
                        min_qual: int):
    """Plain version of K1: the same segment sums in integers, with
    invalid bytes sent to a dump segment past the end (as the JAX
    version does). Returns (counts2 [P,2,8] i32, qual_sum [P,8] f32,
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


def pileup_scatter(rd, starts, ori, strand, mapq, n_pos: int,
                   min_qual: int):
    """K1 launcher (CUDA tensors only): same contract as
    `device_pileup_plain`. Counts its launches in `launches`."""
    dev = rd.device
    if rd.dim() != 2:
        raise ValueError(f"rd: expected [R, L], got {tuple(rd.shape)}")
    R, L = rd.shape
    require(rd, "rd", torch.uint8, (R, L), dev)
    for name, a in (("starts", starts), ("ori", ori), ("strand", strand),
                    ("mapq", mapq)):
        require(a, name, torch.int32, (R,), dev)
    if not 0 < n_pos < (1 << 27):
        raise ValueError(f"n_pos out of range: {n_pos}")
    counts2 = torch.zeros((n_pos, 2, 8), dtype=torch.int32, device=dev)
    qual_sum = torch.zeros((n_pos, 8), dtype=torch.int32, device=dev)
    mapq2_sum = torch.zeros(n_pos, dtype=torch.int64, device=dev)
    if R and L:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _kernels().bsct_pileup_scatter(
                rd.data_ptr(), starts.data_ptr(), ori.data_ptr(),
                strand.data_ptr(), mapq.data_ptr(), R, L, n_pos, min_qual,
                counts2.data_ptr(), qual_sum.data_ptr(),
                mapq2_sum.data_ptr(), stream,
            )
        check_rc(rc, "pileup_scatter")
        pileup_scatter.launches += 1
    return counts2, qual_sum.to(torch.float32), mapq2_sum.to(torch.float32)


pileup_scatter.launches = 0


def device_pileup(rd, starts, ori, strand, mapq, n_pos: int, min_qual: int):
    """Pileup of a read batch for block-relative positions [0, n_pos):
    a CPU batch goes to the plain version, a CUDA batch to K1."""
    kind = rd.device.type
    if kind == "cpu":
        return device_pileup_plain(
            rd, starts, ori, strand, mapq, n_pos, min_qual
        )
    if kind == "cuda":
        return pileup_scatter(rd, starts, ori, strand, mapq, n_pos, min_qual)
    raise ValueError(f"no pileup kernel for device {rd.device}")


def fused_ll_f64(rd, starts, ori, strand, mapq, ref, n_pos: int,
                 min_qual: int, tables: ModelTables):
    """Fused exact tier: read batch -> pileup (K1) -> f32 quality
    rounding + f64 genotype model + finish (K2's pileup entry), in order
    on the current stream with no host round-trip. ref [n_pos] int32.
    Returns (gt_prob [P,10] f64, max_gt [P] i32, margin [P] f64,
    off_sum [P] f64, quals_u8 [P,8])."""
    return _fused(rd, starts, ori, strand, mapq, ref, n_pos, min_qual,
                  tables)[2]


def _fused(rd, starts, ori, strand, mapq, ref, n_pos, min_qual, tables):
    if tables.dtype != torch.float64:
        raise ValueError(
            f"the fused tier needs float64 tables: {tables.dtype}"
        )
    counts2, qual_sum, mapq2_sum = device_pileup(
        rd, starts, ori, strand, mapq, n_pos, min_qual
    )
    return counts2, mapq2_sum, call_genotypes_pileup(
        counts2, qual_sum, ref, tables
    )


def fused_ll_emit(rd, starts, ori, strand, mapq, ref, n_pos: int,
                  min_qual: int, tables: ModelTables, emit: EmitTables,
                  quirk: bool = True):
    """The emit tier: `fused_ll_f64`'s outputs plus the chunk's packed
    emit fields (`emit_device.unpack_fields`), K1 -> K2 -> K3 in order on
    the current stream with no host round-trip (the plain versions for a
    CPU batch). Returns (gt_prob, max_gt, margin, off_sum, quals_u8,
    packed uint8 [n_pos * ROW_BYTES])."""
    counts2, mapq2_sum, out = _fused(
        rd, starts, ori, strand, mapq, ref, n_pos, min_qual, tables
    )
    packed = emit_fields(*out[:4], counts2, mapq2_sum, ref, emit, quirk)
    return (*out, packed)


def pad_read_batch(reads: dict, lo: int, hi: int, r_pad: int, l_cap: int):
    """Slice a block's read batch to the rows that can touch positions
    [lo, hi] (block-relative), shift starts to lo, and pad to the fixed
    (r_pad, l_cap) device shape. Returns (rd, starts, ori, strand, mapq)
    or None when the live rows exceed r_pad / l_cap (caller falls back).
    Padding rows are all-zero bytes: q==0 is never live, so they
    contribute to no segment regardless of their start."""
    starts = reads["starts"]
    lens = reads["lens"]
    keep = (starts <= hi) & (starts + lens - 1 >= lo)
    n = int(keep.sum())
    if n > r_pad or reads["rd"].shape[1] > l_cap:
        return None
    L = reads["rd"].shape[1]
    rd = np.zeros((r_pad, l_cap), np.uint8)
    rd[:n, :L] = reads["rd"][keep]
    out_starts = np.zeros(r_pad, np.int32)
    out_starts[:n] = starts[keep] - lo
    cols = []
    for k in ("ori", "strand", "mapq"):
        a = np.zeros(r_pad, np.int32)
        a[:n] = reads[k][keep]
        cols.append(a)
    return (rd, out_starts, *cols)
