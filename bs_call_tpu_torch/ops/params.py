"""Model parameters and their device tables.

The genotype model has no learned weights: it carries three scalars
(`under_conv`, `over_conv`, `ref_bias`) and the per-quality tables of
`bs_call_tpu.ops.tables` (genotype_model.c:10-21, :87-108). This module
turns those numpy tables into tensors on the caller's device."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bs_call_tpu_torch.ops.tables import NONINF_SEL, qual_tables, ref_prior_matrix


@dataclass(frozen=True)
class ModelParams:
    """Static model parameters (subset of the reference's sr_param);
    the counterpart of `bs_call_tpu.ops.genotype.ModelParams`."""

    under_conv: float = 0.01
    over_conv: float = 0.05
    ref_bias: float = 2.0


@dataclass(frozen=True)
class ModelTables:
    """Tensors of one (params, dtype, device):
    qual   [44, 4]  k, ln k, ln(1/2+k), ln(1+k) per base quality
    prior  [5, 10]  log prior per (ref base N/A/C/G/T, genotype)
    sel    [4, 10]  NONINF_SEL codes (int64)
    l, t            1 - under_conv, over_conv (Python floats)"""

    qual: torch.Tensor
    prior: torch.Tensor
    sel: torch.Tensor
    l: float
    t: float

    @property
    def dtype(self) -> torch.dtype:
        return self.qual.dtype

    @property
    def device(self) -> torch.device:
        return self.qual.device


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def model_tables(params: ModelParams, dtype: torch.dtype,
                 device: torch.device) -> ModelTables:
    if dtype not in _NP_DTYPE:
        raise ValueError(f"model dtype must be float32 or float64: {dtype}")
    nd = _NP_DTYPE[dtype]
    qt = qual_tables(nd)
    qual = np.stack([qt.k, qt.ln_k, qt.ln_k_half, qt.ln_k_one], axis=1)
    return ModelTables(
        qual=torch.from_numpy(np.ascontiguousarray(qual)).to(device),
        prior=torch.from_numpy(ref_prior_matrix(params.ref_bias, nd)).to(
            device
        ),
        sel=torch.from_numpy(NONINF_SEL.astype(np.int64)).to(device),
        l=1.0 - params.under_conv,
        t=params.over_conv,
    )
