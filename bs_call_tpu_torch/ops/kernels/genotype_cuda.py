"""K2 launcher: the genotype likelihood kernel of `csrc/genotype.cu` on
pileup columns (the column tier and `--no-exact`), and the checks every
launcher of the port shares.

Replaces `bs_call_tpu/ops/kernels/genotype_pallas.py` (`_kernel`,
`genotype_ll_pallas`, `call_genotypes_pallas`); the source note in
`csrc/genotype.cu` says what bounds it on the card and how. The plain
PyTorch version is `call_genotypes_plain` in `bs_call_tpu_torch.ops.
genotype`, whose `call_genotypes` dispatches a CPU tensor to it and a
CUDA tensor here. On the fused tier K12 (`pileup_genotype_cuda`) runs the
same model.

The launcher takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs with `torch.empty`, launches on the
current stream without synchronising, raises if the launch reports a CUDA
error, and counts its launches in its `launches` attribute
(`genotype_column` also in `launches_f64` and `launches_f32`, by the
model's dtype).
"""

from __future__ import annotations

import ctypes

import torch

from bs_call_tpu_torch.ops.kernels import _build
from bs_call_tpu_torch.ops.params import ModelTables

_P = ctypes.c_void_p
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load()
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"bsct_genotype_column_{sfx}")
            fn.argtypes = [_P, _P, _P, ctypes.c_longlong, _P, _P,
                           ctypes.c_double, ctypes.c_double, _P, _P, _P, _P,
                           _P]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def require(x, name, dtype, shape, device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on
    `device` (a CUDA device)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.device != device or device.type != "cuda":
        raise ValueError(f"{name}: on {x.device}, kernel runs on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _outputs(n, tables: ModelTables):
    dev, dt = tables.device, tables.dtype
    return (
        torch.empty((n, 10), dtype=dt, device=dev),
        torch.empty(n, dtype=torch.int32, device=dev),
        torch.empty(n, dtype=dt, device=dev),
        torch.empty(n, dtype=dt, device=dev),
    )


def _check_tables(tables: ModelTables):
    if tables.dtype not in _SUFFIX:
        raise ValueError(f"model dtype {tables.dtype} has no kernel")
    require(tables.qual, "tables.qual", tables.dtype, (44, 4), tables.device)
    require(tables.prior, "tables.prior", tables.dtype, (5, 10),
            tables.device)


def genotype_column(counts, quals, ref, tables: ModelTables):
    """K2 column entry: counts [N,8] i32, quals [N,8] i32, ref [N] i32
    -> (gt_prob [N,10], max_gt [N] i32, margin [N], off_sum [N])."""
    dev = tables.device
    _check_tables(tables)
    n = counts.shape[0] if counts.dim() else 0
    require(counts, "counts", torch.int32, (n, 8), dev)
    require(quals, "quals", torch.int32, (n, 8), dev)
    require(ref, "ref", torch.int32, (n,), dev)
    out = _outputs(n, tables)
    if n == 0:
        return out
    fn = getattr(_kernels(), f"bsct_genotype_column_{_SUFFIX[tables.dtype]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            counts.data_ptr(), quals.data_ptr(), ref.data_ptr(), n,
            tables.qual.data_ptr(), tables.prior.data_ptr(), tables.l,
            tables.t, *(o.data_ptr() for o in out), stream,
        )
    check_rc(rc, "genotype_column")
    genotype_column.launches += 1
    if tables.dtype == torch.float64:
        genotype_column.launches_f64 += 1
    else:
        genotype_column.launches_f32 += 1
    return out


genotype_column.launches = 0
genotype_column.launches_f64 = 0
genotype_column.launches_f32 = 0
