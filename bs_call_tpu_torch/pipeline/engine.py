"""Calling engine on a PyTorch device.

`TorchCallEngine` maps a block's pileup (and, in exact mode, its read
batch) to per-position calls. It holds the host logic of the reference's
call path (`call_block_soa`, the C-style finish and scalar-oracle rescue
of `_finish_exact`, the host Fisher strand test) and runs the device tiers
on the device the caller passes:

* fused tier (exact mode): the block's read batch crosses to the device
  once, sorted by start, and K12 builds the pileup and runs the f64 model
  on each tile of positions in one launch; the host compares the device
  quals with its own aggregate and sends rows that differ to the oracle.
  With the emit tier (`BS_CALL_EMIT_TIER`, on unless set to 0, read once
  at construction), K3 also computes the emit fields on the device
  (`fused_ll_emit`) and they come back in one packed copy as
  `soa["dev_prep"]`: the emitter uses every row K3 did not flag and
  recomputes the rest on the host, as does the host Fisher test; with it
  off (`fused_ll_f64`) the host computes Fisher and the emit fields for
  every row. `call_blocks_soa` calls several small blocks in one such
  call, each at its own tile-aligned offset of the chunk;
* column tier: host-built pileup columns go through K2, in f64 (exact)
  or f32 (`--no-exact`), in fixed chunks of `batch_positions` (the tail
  zero-padded) with up to three in flight (`_pipe_chunks`, the JAX
  engine's driver). On a card each of the three slots owns pinned host
  inputs and outputs, device inputs and an event: a chunk's H2D, K2 and
  D2H run in order on the current stream while the host stages the next
  chunk, and the host waits only when it drains the oldest chunk.

With two or more devices (`devices`, by default every visible card when
there are two or more: `CUDA_VISIBLE_DEVICES` chooses them), each chunk's
positions
are sharded over them as the JAX engine shards them over its mesh
(`parallel/sharding.py`): the fused tier runs K12 and K3 on each slab of
whole tiles (`sharded_fused_ll_f64`, `sharded_fused_ll_emit`), the column
tier K2 (`sharded_call_genotypes`), and the outputs are the single
device's bit for bit. Each device has its own tables.

On a CPU device every kernel is its plain PyTorch version. `--device
numpy` has no torch device: `HostCallEngine` calls every position through
the host f64 model (`ops/genotype_native.py`). There is no
race, probe or fallback: an error on the device path, the mesh's
included, propagates. The two
reroutes to the column tier (a chunk whose shape the fused tier does not
take, and a chunk with more than 1% quals mismatches) stay on the same
device and are counted in `tier_positions`.
"""

from __future__ import annotations

import contextlib
import itertools
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.constants import LOG10
from bs_call_tpu_torch.ops import genotype_native, oracle
from bs_call_tpu_torch.ops.emit_tables import emit_tables
from bs_call_tpu_torch.ops.genotype import call_genotypes
from bs_call_tpu_torch.ops.genotype_np import call_genotypes_np
from bs_call_tpu_torch.ops.kernels.emit_device import (
    TIE_MARGIN,
    sharded_fused_ll_emit,
    unpack_fields,
)
from bs_call_tpu_torch.ops.kernels.pileup_device import (
    fused_ll_emit,
    fused_ll_f64,
    pack_read_batch,
    sharded_fused_ll_f64,
    tile_rows,
)
from bs_call_tpu_torch.ops.kernels.pileup_genotype_cuda import MAX_L, TILE
from bs_call_tpu_torch.ops.params import ModelParams, model_tables
from bs_call_tpu_torch.ops.postprocess import aggregate_pileup, fisher_strand
from bs_call_tpu_torch.output.site import SiteCall
from bs_call_tpu_torch.parallel.sharding import (
    make_mesh,
    per_device,
    sharded_call_genotypes,
)
from bs_call_tpu_torch.utils import env_flag
from bs_call_tpu_torch.utils.trace import NULL_TRACER

TIERS = ("fused", "column", "oracle", "shape_reroute", "quals_reroute",
         "emit", "emit_risk")


def engine_devices(device: torch.device):
    """The engine's devices: the mesh of `device`'s kind (`make_mesh`,
    every visible card) when it names two or more, else [device]."""
    mesh = make_mesh(device)
    return mesh if len(mesh) > 1 else [device]


class _Slot:
    """One chunk of the column tier in flight (`_pipe_chunks`): its host
    inputs, counts and quals [bp, 8] and ref [bp] int32 (`host_in`, pinned
    on a card; `inputs`, their numpy views). On a card also its device
    inputs, pinned host outputs gt_prob [bp, 10], max_gt, margin and
    off_sum [bp] in the model's dtype (`host_out`; `outputs`, their numpy
    views), and the event of its D2H."""

    def __init__(self, device: torch.device, dtype: torch.dtype, bp: int):
        card = device.type == "cuda"
        self.host_in = [torch.zeros(shape, dtype=torch.int32, pin_memory=card)
                        for shape in ((bp, 8), (bp, 8), (bp,))]
        self.inputs = [t.numpy() for t in self.host_in]
        if card:
            self.dev_in = [torch.empty_like(t, device=device)
                           for t in self.host_in]
            self.host_out = [
                torch.empty(shape, dtype=dt, pin_memory=True)
                for shape, dt in (((bp, 10), dtype), ((bp,), torch.int32),
                                  ((bp,), dtype), ((bp,), dtype))
            ]
            self.outputs = [t.numpy() for t in self.host_out]
            self.done = torch.cuda.Event()


class TorchCallEngine:
    """Maps (counts2, qual_sum, mapq2_sum, ref) blocks to per-position
    calls, with its device tiers on `device` (cuda or cpu), or position
    sharded over `devices` when that list names two or more (default
    `engine_devices`)."""

    # extra padded positions beyond batch_positions: runner tail chunks
    # carry up to 16 overlap rows
    _FUSED_PAD = 64

    def __init__(self, cfg: CallerConfig, device: torch.device,
                 devices=None):
        self.cfg = cfg
        self.devices = list(devices or engine_devices(device))
        self.device = self.devices[0]
        self.tracer = NULL_TRACER  # the runner sets the job's
        params = ModelParams(
            under_conv=cfg.under_conv,
            over_conv=cfg.over_conv,
            ref_bias=cfg.ref_bias,
        )
        dtype = torch.float64 if cfg.exact else torch.float32
        # one of each per device, in the order of `devices`
        self._tables = per_device(
            self.devices, lambda d: model_tables(params, dtype, d)
        )
        self._emit_tables = per_device(self.devices, emit_tables)
        self._emit_tier = env_flag("BS_CALL_EMIT_TIER", default=True)
        # positions called per tier: fused / column are the device tiers,
        # oracle the rows rescued by the scalar oracle, the *_reroute
        # entries the covered positions the fused tier handed back; emit
        # the covered positions that came back with device emit fields,
        # emit_risk those of them flagged for the host
        self.tier_positions = dict.fromkeys(TIERS, 0)
        self.fused_chunks = 0  # chunks the fused tier carried
        # blocks those chunks carried (several a chunk in `call_blocks_soa`)
        self.fused_blocks = 0
        # chunks of batch_positions the column tier carried (one K2 launch
        # each on one device, one a slab over several)
        self.column_chunks = 0
        self._slots = []  # the column tier's chunk slots (`_column_slots`)

    def wants_reads(self) -> bool:
        """Should the runner export per-block read batches? In exact mode
        the fused tier takes every chunk whose shape it accepts."""
        return self.cfg.exact

    @staticmethod
    def _pow2(n: int, lo: int) -> int:
        p = lo
        while p < n:
            p *= 2
        return p

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        self.tracer.count("h2d_bytes", a.nbytes)
        return torch.from_numpy(a).to(self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        a = t.cpu().numpy()
        self.tracer.count("d2h_bytes", a.nbytes)
        return a

    def _n_pos(self) -> int:
        """The fused tier's chunk width: runner chunks are at most
        max(batch_positions, 1024) + 16 positions."""
        return max(self.cfg.batch_positions, 1024) + self._FUSED_PAD

    def pack_offsets(self, sizes, width: int):
        """Where one fused call places blocks of `sizes` positions, side by
        side, whose reads are at most `width` bytes: the first at 0, each
        segment from a multiple of TILE with l_cap + 1 positions or more
        after it before the next segment or, but for a lone block, the
        chunk's end (l_cap: `width` rounded up to a power of two, at least
        64), so ceil((size + l_cap + 1) / TILE) tiles a segment. Returns
        the offsets, or None where the blocks do not fit one call."""
        n_pos = self._n_pos()
        if width > MAX_L:
            return None
        if len(sizes) == 1:
            return [0] if sizes[0] <= n_pos else None
        gap = self._pow2(width, 64) + 1
        offs = list(itertools.accumulate(
            (-(-(sz + gap) // TILE) * TILE for sz in sizes[:-1]), initial=0))
        return offs if offs[-1] + sizes[-1] + gap <= n_pos else None

    def _call_fused(self, reads: dict, lo: int, hi: int, ref_codes, agg,
                    covered_idx):
        """Fused tier over one block-relative window [lo, hi]: the
        `_call_fused_pack` of a pack of one."""
        return self._call_fused_pack(
            [(reads, lo, hi, ref_codes, agg, covered_idx)])[0]

    def _call_fused_pack(self, parts):
        """Fused tier over blocks placed side by side in one chunk
        (`pack_offsets`): parts [(reads, lo, hi, ref_codes, agg,
        covered_idx)], each a block-relative window [lo, hi] of a block's
        read batch. Returns per part (gt_prob, max_gt, margin, off, prep)
        for its covered rows, with margin 0 on rows whose device quals
        differ from the host aggregate, or None to hand the part to the
        column tier (a lone part whose shape the fused tier does not take,
        a part with more than max(16, 1%) quals mismatches). Parts that do
        not fit one chunk are called one at a time. prep is the emit
        tier's dict of the part's numpy views ([off, off + sz) of the
        packed buffer, `emit_device.unpack_fields`), with quals-mismatch
        rows and the first row flagged risky, or None when the tier is
        off.

        A segment starts on a tile, and no row of another part reaches it
        or its next position: every position of it sums the rows and ref
        of the block's own call, and K3's row after its last row sees the
        same overhang. Only its first row's left neighbour differs (the
        gap's last position, not "unknown"): flagged, as K3 flags row 0
        of a lone call. Stages `call.prep`, `call.h2d`, `call.launch`,
        `call.d2h` (which waits for the card) and `call.finish`; counters
        `h2d_bytes` and `d2h_bytes` (over a mesh, the host batch once:
        rows two slabs share cross twice)."""
        tr = self.tracer
        n_pos = self._n_pos()
        sizes = [hi - lo + 1 for _rd, lo, hi, *_ in parts]
        L = max(p[0]["rd"].shape[1] for p in parts)
        offs = self.pack_offsets(sizes, L)
        if offs is None:
            if len(parts) > 1:
                return [self._call_fused_pack([p])[0] for p in parts]
            self._reroute("shape", len(parts[0][5]),
                          f"{sizes[0]} positions, reads {L} long")
            return [None]
        with tr.stage("call.prep"):
            l_cap = self._pow2(L, 64)
            padded, n_rows = pack_read_batch(
                [(p[0], p[1], p[2], o) for p, o in zip(parts, offs)], l_cap)
            ref_pad = np.zeros(n_pos, np.int32)
            for p, o, sz in zip(parts, offs, sizes):
                ref_pad[o:o + sz] = p[3]
            tiles = tile_rows(padded[1], n_rows, n_pos, l_cap)
            covered_idx = np.concatenate([p[5] + o
                                          for p, o in zip(parts, offs)])
        with tr.stage("call.h2d"):
            if len(self.devices) > 1:
                # each device copies its slab's rows from the host
                host = [np.ascontiguousarray(a) for a in (*padded, ref_pad)]
                tr.count("h2d_bytes",
                         sum(a.nbytes for a in host) + tiles.nbytes)
                args = (self.devices, *map(torch.from_numpy, host))
                kw = dict(tables=self._tables, tiles=tiles)
                model, with_emit = sharded_fused_ll_f64, sharded_fused_ll_emit
                emit = self._emit_tables
            else:
                args = [self._to_device(a) for a in (*padded, ref_pad)]
                kw = dict(tables=self._tables[0],
                          tiles=self._to_device(tiles))
                model, with_emit = fused_ll_f64, fused_ll_emit
                emit = self._emit_tables[0]
            idx = self._to_device(covered_idx.astype(np.int64))
        kw.update(n_pos=n_pos, min_qual=self.cfg.min_qual)
        packed = None
        with tr.stage("call.launch"):
            if self._emit_tier:
                *out, packed = with_emit(*args, **kw, emit=emit,
                                         quirk=self.cfg.reference_quirks)
            else:
                out = model(*args, **kw)
        with tr.stage("call.d2h"):
            gt_prob, max_gt, margin, off, dev_q = (
                self._to_host(t.index_select(0, idx)) for t in out
            )
            if packed is not None:
                packed = self._to_host(packed)
        res = []
        with tr.stage("call.finish"):
            k = 0
            for (_rd, _lo, _hi, _ref, agg, cov), o, sz in zip(parts, offs,
                                                             sizes):
                n_cov = len(cov)
                rows = slice(k, k + n_cov)
                k += n_cov
                mism = (dev_q[rows].astype(np.int32)
                        != agg["quals"][cov]).any(axis=1)
                n_mism = int(mism.sum())
                if n_mism > max(16, n_cov // 100):
                    self._reroute("quals", n_cov,
                                  f"{n_mism} quals mismatches")
                    res.append(None)
                    continue
                # the oracle recomputes these from host inputs
                margin[rows][mism] = 0.0
                self.tier_positions["fused"] += n_cov
                prep = None
                if packed is not None:
                    prep = unpack_fields(packed, n_pos, sz, o)
                    prep["fs_lo"] = np.zeros(sz)
                    # the device built these rows from quals the host
                    # disagrees with: their fields are stale
                    prep["risk"][cov[mism]] = True
                    prep["risk"][0] = True
                    self.tier_positions["emit"] += n_cov
                    self.tier_positions["emit_risk"] += int(
                        prep["risk"][cov].sum()
                    )
                res.append((gt_prob[rows], max_gt[rows], margin[rows],
                            off[rows], prep))
            n_fused = sum(r is not None for r in res)
            if n_fused:
                self.fused_chunks += 1
                self.fused_blocks += n_fused
        return res

    def _reroute(self, why: str, n: int, detail: str) -> None:
        self.tier_positions[f"{why}_reroute"] += n
        self.tracer.progress(f"fused tier -> column tier ({detail})")

    def _call_batch(self, counts, quals, ref):
        """Column tier: K2 over fixed chunks of `batch_positions`
        (`_pipe_chunks`). Returns (gt_prob [N,10] f64, max_gt [N], margin
        [N] f64, off_sum [N] f64) after `_finish_exact`."""
        res = self._pipe_chunks(counts, quals, ref, *self._column_fns())
        self.tier_positions["column"] += len(ref)
        return self._finish_exact(*res, counts, quals, ref)

    # column-tier chunks in flight at once
    WINDOW = 3

    def _column_slots(self, window: int) -> List[_Slot]:
        """`window` chunk slots, allocated on first use and kept for the
        engine's life (its model has one dtype)."""
        if len(self._slots) != window:
            bp = max(self.cfg.batch_positions, 1)
            dtype = self._tables[0].dtype
            self._slots = [_Slot(self.device, dtype, bp)
                           for _ in range(window)]
        return self._slots

    def _column_fns(self):
        """(dispatch, finish) of K2 on the engine's devices, for
        `_pipe_chunks`. On the CPU a chunk is computed when dispatched.
        On one card the H2D into the slot's device inputs, K2 and the D2H
        into its pinned outputs are queued in order on the current stream
        (one stream: a copy stream of its own for the H2D measured no
        faster, `chip_smoke.check_column_pipeline`), so every tensor is
        allocated and read on one stream. Over several devices
        `sharded_call_genotypes` copies each slab from the slot's pinned
        inputs, and the D2H leaves the first device. `finish` waits for
        the slot's event. Each dispatch counts the slot's inputs as
        `h2d_bytes` and its outputs as `d2h_bytes`, on any device."""
        devices, tables, tr = self.devices, self._tables, self.tracer

        def k2(*args):
            if len(devices) > 1:
                return sharded_call_genotypes(devices, *args, tables)
            return call_genotypes(*args, tables[0])

        def count(inputs, outputs):
            tr.count("h2d_bytes", sum(a.nbytes for a in inputs))
            tr.count("d2h_bytes",
                     sum(t.element_size() * t.numel() for t in outputs))

        if self.device.type != "cuda":
            def dispatch(slot):
                res = k2(*(torch.from_numpy(a) for a in slot.inputs))
                count(slot.inputs, res)
                return res

            def finish(res):
                return [t.numpy() for t in res]

            return dispatch, finish

        dev = self.device

        def dispatch(slot):
            if len(devices) > 1:
                res = k2(*slot.host_in)
            else:
                # the slot's last chunk was drained: its K2 has read dev_in
                for d, h in zip(slot.dev_in, slot.host_in):
                    d.copy_(h, non_blocking=True)
                res = k2(*slot.dev_in)
            for h, t in zip(slot.host_out, res):
                h.copy_(t, non_blocking=True)
            count(slot.inputs, res)
            slot.done.record(torch.cuda.current_stream(dev))
            return slot

        def finish(slot):
            slot.done.synchronize()
            return slot.outputs

        return dispatch, finish

    def _pipe_chunks(self, counts, quals, ref, dispatch, finish,
                     window: int = WINDOW):
        """The column tier's chunk driver, the JAX engine's `_pipe_chunks`
        in PyTorch's idiom: fixed chunks of `batch_positions`, the tail
        zero-padded, staged in turn into the host inputs of `window`
        slots (`_column_slots`). `dispatch(slot)` starts a chunk and
        returns what `finish` takes; `finish(token)` waits for it and
        returns its (gt_prob, max_gt, margin, off_sum), batch_positions
        rows each. Up to `window` chunks are in flight: the oldest is
        drained (finished, its unpadded rows copied out) before its slot
        is staged again, so chunks drain in the order they were
        dispatched and the drain is the only wait. An error drains the
        chunks still in flight, dropping their results, and propagates.
        Returns gt_prob [n,10] f64, max_gt [n] int32, margin [n] f64,
        off_sum [n] f64."""
        bp = max(self.cfg.batch_positions, 1)
        n = len(ref)
        out = (np.empty((n, 10)), np.empty(n, np.int32), np.empty(n),
               np.empty(n))
        slots = self._column_slots(window)
        inflight = deque()

        def drain():
            s, e, token = inflight.popleft()
            for dst, src in zip(out, finish(token)):
                dst[s:e] = src[: e - s]

        try:
            for k, s in enumerate(range(0, n, bp)):
                if len(inflight) == window:
                    drain()
                e = min(s + bp, n)
                slot = slots[k % window]
                for buf, a in zip(slot.inputs, (counts, quals, ref)):
                    buf[: e - s] = a[s:e]
                    buf[e - s:] = 0
                inflight.append((s, e, dispatch(slot)))
                self.column_chunks += 1
            while inflight:
                drain()
        except BaseException:
            # the chunks in flight still read and write their slots'
            # buffers: wait for them before any slot is staged again; the
            # first error is the one that propagates
            for _s, _e, token in inflight:
                with contextlib.suppress(Exception):
                    finish(token)
            raise
        return out

    def _finish_exact(self, gt_prob, max_gt, margin, off, counts, quals,
                      ref):
        """C-style max-entry replacement (absorbing 1+off) so the GQ
        phred chain reproduces the reference's double-precision
        quantization, plus (exact mode) the scalar-oracle rescue of true
        ties / libm-ulp boundaries (same libm as the C binary); the
        oracle's gt_prob is already C-style."""
        idx = np.arange(len(max_gt))
        gt_prob[idx, max_gt] = -np.log(1.0 + off) / LOG10
        if self.cfg.exact:
            ties = margin < TIE_MARGIN
            self.tier_positions["oracle"] += int(ties.sum())
            for j in np.nonzero(ties)[0]:
                gt_prob[j], max_gt[j] = oracle.calc_gt_prob(
                    counts[j], quals[j], int(ref[j]),
                    self.cfg.under_conv, self.cfg.over_conv,
                    self.cfg.ref_bias,
                )
        return gt_prob, max_gt, margin, off

    def call_blocks_soa(self, blocks):
        """`call_block_soa` of each of several blocks, blocks [(counts2,
        qual_sum, mapq2_sum, ref_codes, agg, reads)] its arguments, with
        the fused tier of every block that has reads and covered positions
        in one call (`_call_fused_pack`): one H2D of the packed read
        batch, one K12 + K3 launch, one D2H. Each result is the block's
        own call's, array for array, but for the device emit fields that
        `dev_prep` leaves to the host on rows flagged `risk`. Blocks that
        do not fit one chunk (`pack_offsets`) are called one at a time; a
        block whose quals mismatch goes to the column tier alone."""
        with self.tracer.stage("call.prep"):
            aggs = [aggregate_pileup(c2, qs, m2) if agg is None else agg
                    for c2, qs, m2, _ref, agg, _rd in blocks]
            covs = [np.nonzero(a["n"] > 0)[0] for a in aggs]
        pack = [i for i, b in enumerate(blocks)
                if self.cfg.exact and b[5] is not None and len(covs[i])]
        fused = {}
        if len(pack) > 1:
            parts = []
            for i in pack:
                rd_dict, lo = blocks[i][5]
                parts.append((rd_dict, lo, lo + len(aggs[i]["n"]) - 1,
                              blocks[i][3], aggs[i], covs[i]))
            fused = dict(zip(pack, self._call_fused_pack(parts)))
        return [
            self.call_block_soa(c2, qs, m2, ref, agg=agg,
                                reads=None if i in fused else reads,
                                fused=fused.get(i))
            for i, ((c2, qs, m2, ref, _agg, reads), agg)
            in enumerate(zip(blocks, aggs))
        ]

    def call_block_soa(self, counts2, qual_sum, mapq2_sum, ref_codes,
                       agg=None, reads=None, fused=None):
        """counts2 [sz,2,8], qual_sum [sz,8], mapq2_sum [sz],
        ref_codes [sz]. Returns a dict of position-major arrays:
        covered [sz] bool; counts [sz,8]; quals [sz,8]; mq, aq [sz];
        gt_prob [sz,10] f64; max_gt [sz]; fs [sz] f64; and, when the
        emit tier carried the chunk, dev_prep (the device emit fields).
        `agg` may carry natively precomputed aggregates. `reads`, when
        given, is (read_batch_dict, lo) with lo the block-relative
        offset of this window's first position: it enables the fused
        tier (reads cross H2D instead of pileup columns). `fused`, when
        given, is the block's share of a packed call (`call_blocks_soa`),
        which stands in for its own fused call. Stages on
        `self.tracer`: `call.prep`, `_call_fused`'s, `call.column` (the
        column tier) and `call.finish` (`_finish_exact`, the emit tier's
        risk bands, the host Fisher test)."""
        tr = self.tracer
        with tr.stage("call.prep"):
            if agg is None:
                agg = aggregate_pileup(counts2, qual_sum, mapq2_sum)
            counts = agg["counts"]
            sz = len(agg["n"])
            covered_mask = agg["n"] > 0
            covered = np.nonzero(covered_mask)[0]
            gt_prob_full = np.zeros((sz, 10), dtype=np.float64)
            max_gt_full = np.zeros(sz, dtype=np.int32)
            fs_full = np.zeros(sz, dtype=np.float64)
            if len(covered):
                ccounts = counts[covered].astype(np.int32)
                cquals = agg["quals"][covered]
                cref = np.asarray(ref_codes, dtype=np.int32)[covered]
        prep = None
        if len(covered):
            if fused is None and reads is not None and self.cfg.exact:
                rd_dict, lo = reads
                fused = self._call_fused(
                    rd_dict, lo, lo + sz - 1, ref_codes, agg, covered
                )
            if fused is None:
                with tr.stage("call.column"):
                    res = self._call_batch(ccounts, cquals, cref)
            with tr.stage("call.finish"):
                if fused is not None:
                    prep = fused[4]
                    res = self._finish_exact(*fused[:4], ccounts, cquals,
                                             cref)
                gt_prob, max_gt, margin, _off = res
                gt_prob_full[covered] = gt_prob
                max_gt_full[covered] = max_gt
                if prep is not None:
                    # host-side staleness: any row the exact tiers rescued
                    # (ll tie / quals mismatch -> margin 0, or a changed
                    # winner) invalidates its own prep AND its neighbours'
                    # CG context; the device fs then carries only rows the
                    # guard bands certify, the host Fisher test the rest
                    risk = prep["risk"].copy()
                    final_gt1 = np.where(
                        covered_mask, max_gt_full + 1, 0
                    ).astype(prep["gt1"].dtype)
                    changed = prep["gt1"] != final_gt1
                    risk |= changed
                    risk[:-1] |= changed[1:]
                    risk[1:] |= changed[:-1]
                    mfull = np.full(sz, np.inf)
                    mfull[covered] = margin
                    risk |= covered_mask & (mfull < 1e-8)
                    prep["risk"] = risk
                    fs_w = (prep["fs_hi"].astype(np.float64)
                            + prep["fs_lo"].astype(np.float64))
                    fs_w[~covered_mask] = 0.0
                    rc = np.nonzero(covered_mask & risk)[0]
                    if len(rc):
                        fs_w[rc] = fisher_strand(
                            counts2[rc], max_gt_full[rc],
                            not self.cfg.reference_quirks,
                        )
                    fs_full[:] = fs_w
                else:
                    fs_full[covered] = fisher_strand(
                        counts2[covered], max_gt,
                        not self.cfg.reference_quirks,
                    )
        soa = {
            "covered": covered_mask,
            "counts": counts,
            "quals": agg["quals"],
            "mq": agg["mq"],
            "aq": agg["aq"],
            "gt_prob": gt_prob_full,
            "max_gt": max_gt_full,
            "fs": fs_full,
        }
        if prep is not None:
            soa["dev_prep"] = prep
        return soa


class HostCallEngine(TorchCallEngine):
    """`--device numpy`: the engine without a torch device, as
    `bs_call_tpu`'s engine runs under `--device numpy`. Every covered
    position goes through the host f64 model, exact or not
    (`genotype_native.native_model`, or `call_genotypes_np` under
    BS_CALL_PY_MODEL=1), then `_finish_exact`; no fused tier, emit tier or
    read export, and no tier counts but `oracle`. Where the runner's
    row-engine gate holds (`runner._row_engine_gate`), native ingest and
    the host row engine (`native/rowengine.py`) carry the blocks of 9 or
    more positions and this engine only the smaller ones; otherwise it
    carries every block of the Python record path. Raises at
    construction when the native library does not load (the JAX engine
    falls back to numpy there)."""

    def __init__(self, cfg: CallerConfig):
        self.cfg = cfg
        self.devices = []
        self.tracer = NULL_TRACER
        self.tier_positions = dict.fromkeys(TIERS, 0)
        self.fused_chunks = self.fused_blocks = self.column_chunks = 0
        self._model = genotype_native.native_model(
            cfg.under_conv, cfg.over_conv, cfg.ref_bias
        )

    def wants_reads(self) -> bool:
        return False

    def _call_batch(self, counts, quals, ref):
        cfg = self.cfg
        if self._model is not None:
            res = self._model.call(counts, quals, ref)
        else:
            res = call_genotypes_np(counts, quals, ref, cfg.under_conv,
                                    cfg.over_conv, cfg.ref_bias)
        return self._finish_exact(*res, counts, quals, ref)


def soa_to_calls(soa) -> List[Optional[SiteCall]]:
    """Per-position SiteCall objects from a call_block_soa result (the
    scalar emitter's input shape)."""
    out: List[Optional[SiteCall]] = [None] * len(soa["covered"])
    for j in np.nonzero(soa["covered"])[0]:
        out[j] = SiteCall(
            counts=soa["counts"][j],
            quals=soa["quals"][j],
            gt_prob=soa["gt_prob"][j],
            fisher_strand=soa["fs"][j],
            mq=int(soa["mq"][j]),
            aq=int(soa["aq"][j]),
            max_gt=int(soa["max_gt"][j]),
        )
    return out
