"""K3 launcher: the emit-fields kernel of `csrc/emit.cu`, and the layout
of its packed output.

Replaces the XLA program `emit_fields_dd` of
`bs_call_tpu/ops/kernels/emit_device.py` (with `_fisher_dd` and
`_cg_codes`); the source note in `csrc/emit.cu` says what bounds it on
the card and how. The plain PyTorch version is `emit_fields_plain` in
`ops/kernels/emit_device.py`, whose `emit_fields` dispatches a CPU
tensor there and a CUDA tensor here.

K3 writes every field of a chunk into ONE byte buffer, struct of arrays
in LAYOUT order (each field's rows contiguous), so the fields come back
to the host in a single D2H copy.
"""

from __future__ import annotations

import ctypes

import torch

from bs_call_tpu_torch.ops.emit_tables import PACKED_N, EmitTables
from bs_call_tpu_torch.ops.kernels import _build
from bs_call_tpu_torch.ops.kernels.genotype_cuda import check_rc, require

# (field, dtype, values per row), in buffer order; csrc/emit.cu writes
# the same offsets. Widths: phred, qd <= 255, fs_int in [0, 200], flt 4
# bits, gl_len <= 5, gt1/max_gt/ref5 small codes, cg_code an ASCII char.
LAYOUT = (
    ("fs_hi", torch.float64, 1),
    ("gl_vals", torch.float32, 5),
    ("dp1", torch.int32, 1),
    ("mq", torch.int32, 1),
    ("risk", torch.bool, 1),
    ("covered", torch.bool, 1),
    ("gt1", torch.uint8, 1),
    ("max_gt", torch.uint8, 1),
    ("ref5", torch.uint8, 1),
    ("phred", torch.uint8, 1),
    ("qd", torch.uint8, 1),
    ("fs_int", torch.uint8, 1),
    ("flt", torch.uint8, 1),
    ("mac1", torch.bool, 1),
    ("gl_len", torch.uint8, 1),
    ("cg_code", torch.uint8, 1),
    ("cond_cg", torch.bool, 1),
    ("het", torch.bool, 1),
)
ROW_BYTES = sum(dt.itemsize * k for _, dt, k in LAYOUT)  # 50

_P = ctypes.c_void_p
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load()
        lib.bsct_emit_fields.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P,
            ctypes.c_int, _P, _P,
        ]
        lib.bsct_emit_fields.restype = ctypes.c_int
        _lib = lib
    return _lib


def emit_fields_cuda(gt_prob, max_gt, margin, off, counts2, mapq2_sum, ref,
                     tables: EmitTables, quirk: bool = True):
    """K3: K2's outputs (gt_prob [N,10] f64, max_gt [N] i32, margin [N]
    f64, off_sum [N] f64) plus K1's counts2 [N,2,8] i32 and mapq2_sum [N]
    f32 and ref [N] i32 -> the packed fields, uint8 [N * ROW_BYTES].
    CUDA tensors only; counts its launches in `launches`."""
    dev = gt_prob.device
    n = gt_prob.shape[0] if gt_prob.dim() else 0
    require(gt_prob, "gt_prob", torch.float64, (n, 10), dev)
    require(max_gt, "max_gt", torch.int32, (n,), dev)
    require(margin, "margin", torch.float64, (n,), dev)
    require(off, "off", torch.float64, (n,), dev)
    require(counts2, "counts2", torch.int32, (n, 2, 8), dev)
    require(mapq2_sum, "mapq2_sum", torch.float32, (n,), dev)
    require(ref, "ref", torch.int32, (n,), dev)
    require(tables.packed, "tables.packed", torch.int32, (PACKED_N,), dev)
    require(tables.lfact, "tables.lfact", torch.float64, (256,), dev)
    out = torch.empty(n * ROW_BYTES, dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernels().bsct_emit_fields(
            gt_prob.data_ptr(), max_gt.data_ptr(), margin.data_ptr(),
            off.data_ptr(), counts2.data_ptr(), mapq2_sum.data_ptr(),
            ref.data_ptr(), n, tables.packed.data_ptr(),
            tables.lfact.data_ptr(), int(bool(quirk)), out.data_ptr(),
            stream,
        )
    check_rc(rc, "emit_fields")
    emit_fields_cuda.launches += 1
    return out


emit_fields_cuda.launches = 0
