"""Calling engine on a PyTorch device.

`TorchCallEngine` keeps the host logic of `bs_call_tpu`'s `CallEngine`
(`call_block_soa`, the C-style finish and scalar-oracle rescue of
`_finish_exact`, the host Fisher strand test) and replaces its device
tiers with PyTorch ones on the device the caller passes:

* fused tier (exact mode): the block's read batch crosses to the device
  once, K1 builds the pileup and K2 runs the f64 model on it; the host
  compares the device quals with its own aggregate and sends rows that
  differ to the oracle. With the emit tier (`BS_CALL_EMIT_TIER`, on
  unless set to 0, read once at construction as the JAX engine reads
  it), K3 also computes the emit fields on the device (`fused_ll_emit`)
  and they come back in one packed copy as `soa["dev_prep"]`: the
  emitter uses every row K3 did not flag and recomputes the rest on the
  host, as does the host Fisher test; with it off (`fused_ll_f64`) the
  host computes Fisher and the emit fields for every row;
* column tier: host-built pileup columns go through K2, in f64 (exact)
  or f32 (`--no-exact`), in chunks of `batch_positions`, in order on the
  current stream.

On a CPU device every kernel is its plain PyTorch version. There is no
race, probe or fallback: an error on the device path propagates. The two
reroutes to the column tier (a chunk whose shape the fused tier does not
take, and a chunk with more than 1% quals mismatches) stay on the same
device and are counted in `tier_positions`.
"""

from __future__ import annotations

import numpy as np
import torch

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.pipeline.engine import CallEngine
from bs_call_tpu_torch.ops.emit_tables import emit_tables
from bs_call_tpu_torch.ops.genotype import call_genotypes
from bs_call_tpu_torch.ops.kernels.emit_device import (
    TIE_MARGIN,
    unpack_fields,
)
from bs_call_tpu_torch.ops.kernels.pileup_device import (
    fused_ll_emit,
    fused_ll_f64,
    pad_read_batch,
)
from bs_call_tpu_torch.ops.params import ModelParams, model_tables

TIERS = ("fused", "column", "oracle", "shape_reroute", "quals_reroute",
         "emit", "emit_risk")


class TorchCallEngine(CallEngine):
    """CallEngine whose device tiers run on `device` (cuda or cpu)."""

    def __init__(self, cfg: CallerConfig, device: torch.device):
        super().__init__(cfg)
        self.device = device
        params = ModelParams(
            under_conv=cfg.under_conv,
            over_conv=cfg.over_conv,
            ref_bias=cfg.ref_bias,
        )
        dtype = torch.float64 if cfg.exact else torch.float32
        self._tables = model_tables(params, dtype, device)
        self._emit_tables = emit_tables(device)
        # positions called per tier: fused / column are the device tiers,
        # oracle the rows rescued by the scalar oracle, the *_reroute
        # entries the covered positions the fused tier handed back; emit
        # the covered positions that came back with device emit fields,
        # emit_risk those of them flagged for the host
        self.tier_positions = dict.fromkeys(TIERS, 0)

    @property
    def _jax(self):
        raise RuntimeError("bs_call_tpu_torch never runs the JAX engines")

    def _prefer_xla_f64(self) -> bool:
        return False

    def wants_reads(self) -> bool:
        return self.cfg.exact

    def _fused_gate(self, reads, lo, hi, ref_codes, agg, covered_idx):
        return self.cfg.exact

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _call_fused(self, reads: dict, lo: int, hi: int, ref_codes, agg,
                    covered_idx):
        """Fused tier over block-relative window [lo, hi]. Returns
        (gt_prob, max_gt, margin, off, prep) for the covered rows, with
        margin 0 on rows whose device quals differ from the host
        aggregate, or None to hand the chunk to the column tier. prep is
        the emit tier's dict of window-aligned numpy views ([:sz] of the
        packed buffer, `emit_device.unpack_fields`), with quals-mismatch
        rows flagged risky, or None when the tier is off."""
        sz = hi - lo + 1
        # runner chunks are at most max(batch_positions, 1024) + 16 wide
        n_pos = max(self.cfg.batch_positions, 1024) + self._FUSED_PAD
        L = reads["rd"].shape[1]
        n_cov = len(covered_idx)
        padded = None
        if sz <= n_pos and L <= 2048:
            starts = reads["starts"]
            n_rows = int(
                ((starts <= hi) & (starts + reads["lens"] - 1 >= lo)).sum()
            )
            r_pad = self._pow2(max(n_rows, 1), 1024)
            padded = pad_read_batch(reads, lo, hi, r_pad, self._pow2(L, 64))
        if padded is None:
            self._reroute("shape", n_cov, f"{sz} positions, reads {L} long")
            return None
        ref_pad = np.zeros(n_pos, np.int32)
        ref_pad[:sz] = np.asarray(ref_codes, dtype=np.int32)
        args = [self._to_device(a) for a in (*padded, ref_pad)]
        packed = None
        if self._emit_tier:
            *out, packed = fused_ll_emit(
                *args, n_pos=n_pos, min_qual=self.cfg.min_qual,
                tables=self._tables, emit=self._emit_tables,
                quirk=self.cfg.reference_quirks,
            )
        else:
            out = fused_ll_f64(
                *args, n_pos=n_pos, min_qual=self.cfg.min_qual,
                tables=self._tables,
            )
        idx = self._to_device(covered_idx.astype(np.int64))
        gt_prob, max_gt, margin, off, dev_q = (
            t.index_select(0, idx).cpu().numpy() for t in out
        )
        mism = (dev_q.astype(np.int32) != agg["quals"][covered_idx]).any(
            axis=1
        )
        n_mism = int(mism.sum())
        if n_mism > max(16, n_cov // 100):
            self._reroute("quals", n_cov, f"{n_mism} quals mismatches")
            return None
        margin[mism] = 0.0  # the oracle recomputes these from host inputs
        self.tier_positions["fused"] += n_cov
        prep = None
        if packed is not None:
            prep = unpack_fields(packed.cpu().numpy(), n_pos, sz)
            prep["fs_lo"] = np.zeros(sz)
            # the device built these rows from quals the host disagrees
            # with: their fields are stale
            prep["risk"][covered_idx[mism]] = True
            self.tier_positions["emit"] += n_cov
            self.tier_positions["emit_risk"] += int(
                prep["risk"][covered_idx].sum()
            )
        return gt_prob, max_gt, margin, off, prep

    def _reroute(self, why: str, n: int, detail: str) -> None:
        self.tier_positions[f"{why}_reroute"] += n
        if self.tracer is not None:
            self.tracer.progress(f"fused tier -> column tier ({detail})")

    def _call_batch(self, counts, quals, ref):
        """Column tier: K2 over `batch_positions`-sized chunks. Returns
        (gt_prob [N,10] f64, max_gt [N], margin [N] f64, off_sum [N] f64)
        after `_finish_exact`."""
        n = len(ref)
        gt_prob = np.empty((n, 10), dtype=np.float64)
        max_gt = np.empty(n, dtype=np.int32)
        margin = np.empty(n, dtype=np.float64)
        off = np.empty(n, dtype=np.float64)
        bp = max(self.cfg.batch_positions, 1)
        for s in range(0, n, bp):
            e = min(s + bp, n)
            res = call_genotypes(
                self._to_device(counts[s:e].astype(np.int32, copy=False)),
                self._to_device(quals[s:e].astype(np.int32, copy=False)),
                self._to_device(ref[s:e].astype(np.int32, copy=False)),
                self._tables,
            )
            for dst, t in zip((gt_prob, max_gt, margin, off), res):
                dst[s:e] = t.cpu().numpy()
        self.tier_positions["column"] += n
        return self._finish_exact(
            gt_prob, max_gt, margin, off, counts, quals, ref
        )

    def _finish_exact(self, gt_prob, max_gt, margin, off, counts, quals,
                      ref):
        if self.cfg.exact:
            self.tier_positions["oracle"] += int(
                (margin < TIE_MARGIN).sum()
            )
        return super()._finish_exact(
            gt_prob, max_gt, margin, off, counts, quals, ref
        )
