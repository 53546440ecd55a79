"""Lookup tables of the emit tier as tensors on the caller's device.

Every table is the JAX package's own numpy array, carried across
unchanged, so the host emitter (`bsc_emit.cpp`, fed from
`output/vector_site.py`), the JAX emit tier and the port read one source
of truth:

    het        [10]    bool   GT_HET (constants.py)
    ftab_a/_b  [10,8]  int64  Fisher 2x2 column categories per genotype
                              (ops/postprocess.py _FTAB_MASK_A/_B)
    mac_a/_b   [10,8]  int64  mac1 minor-allele categories (MAC_MASK_A/_B)
    mac_valid  [10]    bool   genotypes with a mac1 rule (MAC_VALID)
    gl_idx     [50,5]  int64  (genotype*5 + ref) -> gt_prob slot of each
                              printed GL value; -1 reads slot 0, -2 is a
                              fixed -99.999 (vector_site.py _GL_IDX_C)
    gl_len     [50]    int64  printed GL count (_GL_LEN_C)
    cflag/gflag [10]   bool   genotype holds a C / a G (_CFLAG_U8/_GFLAG_U8)
    lfact      [256]   f64    log-factorial memo, constants.lfact_store():
                              the serial log accumulation of
                              bsc_stats.cpp:24-34, the same bytes as the
                              host's table (arguments >= 256 call lgamma)

`packed` is the int tables concatenated in PACKED_ORDER as one int32
tensor, the layout K3 (`csrc/emit.cu`) copies into shared memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bs_call_tpu.constants import GT_HET, lfact_store
from bs_call_tpu.ops.postprocess import (
    _FTAB_MASK_A,
    _FTAB_MASK_B,
    MAC_MASK_A,
    MAC_MASK_B,
    MAC_VALID,
)
from bs_call_tpu.output.vector_site import (
    _CFLAG_U8,
    _GFLAG_U8,
    _GL_IDX_C,
    _GL_LEN_C,
)

# order and sizes of `packed`; csrc/emit.cu hard-codes the same offsets
PACKED_ORDER = (
    ("het", 10), ("cflag", 10), ("gflag", 10), ("mac_valid", 10),
    ("ftab_a", 80), ("ftab_b", 80), ("mac_a", 80), ("mac_b", 80),
    ("gl_idx", 250), ("gl_len", 50),
)
PACKED_N = sum(size for _, size in PACKED_ORDER)


@dataclass(frozen=True)
class EmitTables:
    het: torch.Tensor
    ftab_a: torch.Tensor
    ftab_b: torch.Tensor
    mac_a: torch.Tensor
    mac_b: torch.Tensor
    mac_valid: torch.Tensor
    gl_idx: torch.Tensor
    gl_len: torch.Tensor
    cflag: torch.Tensor
    gflag: torch.Tensor
    lfact: torch.Tensor
    packed: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.lfact.device


def emit_tables(device: torch.device) -> EmitTables:
    arrays = {
        "het": np.asarray(GT_HET, dtype=bool),
        "ftab_a": _FTAB_MASK_A, "ftab_b": _FTAB_MASK_B,
        "mac_a": MAC_MASK_A, "mac_b": MAC_MASK_B,
        "mac_valid": np.asarray(MAC_VALID, dtype=bool),
        "gl_idx": _GL_IDX_C.reshape(50, 5), "gl_len": _GL_LEN_C.reshape(50),
        "cflag": _CFLAG_U8.astype(bool), "gflag": _GFLAG_U8.astype(bool),
    }
    packed = np.concatenate([
        arrays[name].astype(np.int32).reshape(-1) for name, _ in PACKED_ORDER
    ])
    if len(packed) != PACKED_N:
        raise AssertionError("emit table sizes changed: update PACKED_ORDER")

    def dev(a):
        a = np.ascontiguousarray(a)
        if a.dtype != bool:
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device)

    return EmitTables(
        **{k: dev(v) for k, v in arrays.items()},
        lfact=torch.from_numpy(lfact_store(np.float64)).to(device),
        packed=torch.from_numpy(packed).to(device),
    )
