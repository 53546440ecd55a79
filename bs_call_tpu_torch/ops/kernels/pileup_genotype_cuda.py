"""K12 launcher: the pileup and the genotype model per position tile, the
kernel of `csrc/pileup_genotype.cu`.

K12 computes the pileup of a read batch and the genotype model on it in
one launch: each CTA of 16 warps takes one tile of TILE positions,
stages the read rows that meet it into shared memory with bulk copies
(TMA), accumulates the tile's pileup there with integer atomics, a
quarter of the tile a warp, writes the tile's pileup planes once, and
runs the 10-genotype model and finish on them from shared memory on
K2's task split (six log tasks a position over four rows of warps). Its plain PyTorch version is `pileup_device.device_pileup_plain`
followed by `genotype.call_genotypes_pileup_plain`; `pileup_device`'s
`fused_pileup_call`, `fused_ll_f64` and `fused_ll_emit` send a CPU batch
there and a CUDA batch here.

The launcher takes CUDA tensors only, checks them, allocates its outputs
with `torch.empty` (the kernel writes every position), launches on the
current stream without synchronising, raises if the launch reports a
CUDA error, and counts its launches in `pileup_genotype.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from bs_call_tpu_torch.ops.kernels import _build
from bs_call_tpu_torch.ops.kernels.genotype_cuda import check_rc, require
from bs_call_tpu_torch.ops.params import ModelTables

TILE = 128  # positions per CTA; csrc/pileup_genotype.cu kTile
MIN_L, MAX_L = 64, 2048  # row widths K12 takes, multiples of 16
_P = ctypes.c_void_p
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load()
        i = ctypes.c_int
        lib.bsct_pileup_genotype_tile.argtypes = []
        lib.bsct_pileup_genotype_tile.restype = i
        if lib.bsct_pileup_genotype_tile() != TILE:
            raise RuntimeError("K12 was built with another tile size")
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"bsct_pileup_genotype_{sfx}")
            fn.argtypes = [
                _P, _P, _P, _P, _P, _P, i, i, i, i, _P, _P, _P,
                ctypes.c_double, ctypes.c_double, *[_P] * 8, _P,
            ]
            fn.restype = i
        _lib = lib
    return _lib


def pileup_genotype(rd, starts, ori, strand, mapq, tiles, ref, n_pos: int,
                    min_qual: int, tables: ModelTables):
    """rd [R, L] u8 (L a multiple of 16 in [64, 2048]), starts/ori/
    strand/mapq [R] i32 with the live rows sorted by start, tiles [ceil(n_pos/TILE), 2] i32
    (`pileup_device.tile_rows`), ref [n_pos] i32 -> (counts2 [n_pos,2,8]
    i32, qual_sum [n_pos,8] f32, mapq2_sum [n_pos] f32, gt_prob
    [n_pos,10], max_gt [n_pos] i32, margin [n_pos], off_sum [n_pos],
    quals_u8 [n_pos,8] u8), the float planes in tables.dtype."""
    dev = tables.device
    if tables.dtype not in _SUFFIX:
        raise ValueError(f"model dtype {tables.dtype} has no kernel")
    if rd.dim() != 2:
        raise ValueError(f"rd: expected [R, L], got {tuple(rd.shape)}")
    R, L = rd.shape
    if not 0 < n_pos < (1 << 27):
        raise ValueError(f"n_pos out of range: {n_pos}")
    n_tiles = -(-n_pos // TILE)
    require(rd, "rd", torch.uint8, (R, L), dev)
    for name, a in (("starts", starts), ("ori", ori), ("strand", strand),
                    ("mapq", mapq)):
        require(a, name, torch.int32, (R,), dev)
    require(tiles, "tiles", torch.int32, (n_tiles, 2), dev)
    require(ref, "ref", torch.int32, (n_pos,), dev)
    require(tables.qual, "tables.qual", tables.dtype, (44, 4), dev)
    require(tables.prior, "tables.prior", tables.dtype, (5, 10), dev)
    if not MIN_L <= L <= MAX_L or L % 16 or rd.data_ptr() % 16:
        raise ValueError(
            f"rd: rows of {L} bytes; K12 takes {MIN_L}..{MAX_L}, a multiple "
            "of 16, 16-byte aligned"
        )
    i32, dt = torch.int32, tables.dtype
    out = (
        torch.empty((n_pos, 2, 8), dtype=i32, device=dev),
        torch.empty((n_pos, 8), dtype=torch.float32, device=dev),
        torch.empty(n_pos, dtype=torch.float32, device=dev),
        torch.empty((n_pos, 10), dtype=dt, device=dev),
        torch.empty(n_pos, dtype=i32, device=dev),
        torch.empty(n_pos, dtype=dt, device=dev),
        torch.empty(n_pos, dtype=dt, device=dev),
        torch.empty((n_pos, 8), dtype=torch.uint8, device=dev),
    )
    fn = getattr(_kernels(), f"bsct_pileup_genotype_{_SUFFIX[dt]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            rd.data_ptr(), starts.data_ptr(), ori.data_ptr(),
            strand.data_ptr(), mapq.data_ptr(), tiles.data_ptr(), R, L,
            n_pos, min_qual, ref.data_ptr(), tables.qual.data_ptr(),
            tables.prior.data_ptr(), tables.l, tables.t,
            *(o.data_ptr() for o in out), stream,
        )
    check_rc(rc, "pileup_genotype")
    pileup_genotype.launches += 1
    return out


pileup_genotype.launches = 0
