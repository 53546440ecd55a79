"""Position sharding of the calling step over a list of devices.

Counterpart of `bs_call_tpu/parallel/sharding.py`. There a JAX `Mesh`
names the chips and `shard_map` runs one program on each; here the mesh
is an explicit list of `torch.device`s that one process owns, the calls
are made slab by slab (each launch is asynchronous, so the devices work
at once), and each collective is an explicit copy between devices:

  - the 1-position halo at a slab border is a copy of one row
    (`Tensor.to(device, non_blocking=True)`: PyTorch orders a copy
    between two cards after the work already queued on both);
  - the psum of the stats histograms is a sum of the slabs' histograms on
    the first device.

A slab is a run of whole tiles of TILE positions (`slabs`), as even as
whole tiles allow: K12 (`csrc/pileup_genotype.cu`) takes its positions a
tile at a time, so each slab's outputs are the whole chunk's bit for bit.
The model is a pure per-position map,
so the sharded calls need no collective beyond the halo and the
histograms. A list may name one device, or one device more than once:
the CPU tests run `[cpu] * 4`, and one card can hold several slabs.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from bs_call_tpu_torch.constants import LOG10
from bs_call_tpu_torch.ops.genotype import call_genotypes
from bs_call_tpu_torch.ops.kernels.pileup_genotype_cuda import TILE
from bs_call_tpu_torch.ops.params import ModelTables


def make_mesh(device: torch.device) -> List[torch.device]:
    """The devices of a position mesh: for a CUDA device, cuda:0 ...
    cuda:k-1 of the cards this process sees (CUDA_VISIBLE_DEVICES chooses
    them); for the CPU, the one CPU device."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def per_device(devices: Sequence[torch.device],
               make: Callable[[torch.device], object]) -> list:
    """[make(d) for d in devices], built once for each distinct device."""
    built = {}
    for d in devices:
        if d not in built:
            built[d] = make(d)
    return [built[d] for d in devices]


def slabs(n: int, n_devices: int) -> List[Tuple[int, int]]:
    """Position ranges [lo, hi) of n positions, one per device (fewer when
    n has fewer tiles than there are devices), each a run of whole tiles of
    TILE positions, the first ones one tile longer where the tiles do not
    divide evenly."""
    n_tiles = -(-n // TILE)
    k = max(1, min(n_devices, n_tiles))
    size, extra = divmod(n_tiles, k)
    out, t = [], 0
    for i in range(k):
        t1 = t + size + (i < extra)
        out.append((t * TILE, min(t1 * TILE, n)))
        t = t1
    return out


def shard_positions(devices: Sequence[torch.device], *tensors):
    """Position-major tensors cut into `slabs`, each slab's pieces copied to
    its device: a list with one tuple per slab."""
    n = tensors[0].shape[0]
    return [tuple(t[lo:hi].to(dev, non_blocking=True) for t in tensors)
            for (lo, hi), dev in zip(slabs(n, len(devices)), devices)]


def gather(parts, device: torch.device) -> torch.Tensor:
    """The slabs' pieces of one output, in order, on `device`."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def halo(parts, fill):
    """The 1-position halo of a sharded 1-D tensor: for each slab's piece,
    (the value just before it, the value just after it), [1] each on the
    piece's device, copied from the neighbour slab's border row, `fill` at
    the two ends of the whole."""
    out = []
    for k, v in enumerate(parts):
        prev = (parts[k - 1][-1:].to(v.device, non_blocking=True) if k
                else v.new_full((1,), fill))
        nxt = (parts[k + 1][:1].to(v.device, non_blocking=True)
               if k + 1 < len(parts) else v.new_full((1,), fill))
        out.append((prev, nxt))
    return out


def sharded_call_genotypes(devices, counts, quals, ref,
                           tables: Sequence[ModelTables]):
    """`ops.genotype.call_genotypes` (K2's column entry on a card, its
    plain version on the CPU) over the mesh: counts/quals [B,8], ref [B],
    on any device, cut into slabs, each slab on its device with its
    device's tables (one per device, `per_device`). Returns (gt_prob
    [B,10], max_gt [B], margin [B], off_sum [B]) on the first device, bit
    for bit the single-device call's."""
    outs = [call_genotypes(c, q, r, t) for (c, q, r), t in
            zip(shard_positions(devices, counts, quals, ref), tables)]
    return tuple(gather([o[j] for o in outs], devices[0]) for j in range(4))


def sharded_ll_f64(devices, counts, quals, ref,
                   tables: Sequence[ModelTables]):
    """The counterpart of `sharded_ll_dd`: the exact tier's model over the
    mesh. The JAX package computed it in double-float32 for the TPU; here
    it is K2 in real f64, so the tables must be float64."""
    if any(t.dtype != torch.float64 for t in tables):
        raise ValueError("sharded_ll_f64 needs float64 tables")
    return sharded_call_genotypes(devices, counts, quals, ref, tables)


def sharded_full_step(devices, counts, quals, ref,
                      tables: Sequence[ModelTables]):
    """The calling step per slab, with the emitter's halo context.
    counts/quals [N,8], ref [N] -> dict of [N] outputs on the first device
    (the JAX function's keys): gt_prob [N,10] (log10 posteriors with the
    C-style max entry -log(1+off)/ln 10), max_gt, margin, off_sum,
    covered, gt1 (1-based codes, 0 uncalled), prev_gt/next_gt and
    prev_skip/next_skip (the neighbours' codes and hom-ref-skip bits
    across slab borders, through the halo; 0 / False at the ends),
    cg_mask (called CpG pairs), and gt_hist [10], cov_hist [64] (int32,
    the slabs' histograms summed on the first device)."""
    steps = []
    for (c, q, r), t in zip(shard_positions(devices, counts, quals, ref),
                            tables):
        gp, mx, margin, off = call_genotypes(c, q, r, t)
        rows = torch.arange(len(mx), device=mx.device)
        gp = gp.clone()
        gp[rows, mx.long()] = -torch.log1p(off) / LOG10
        depth_sum = c.sum(dim=1)
        covered = depth_sum > 0
        gt1 = torch.where(covered, mx + 1, 0).to(torch.int32)
        skip = ((gt1 == 1) & (r == 1)) | ((gt1 == 10) & (r == 4))
        hist = torch.zeros(10, dtype=torch.int32, device=mx.device)
        hist.index_add_(0, mx.long(), covered.to(torch.int32))
        cov = torch.zeros(64, dtype=torch.int32, device=mx.device)
        cov.index_add_(0, depth_sum.clamp(0, 63).long(),
                       covered.to(torch.int32))
        steps.append({"gt_prob": gp, "max_gt": mx, "margin": margin,
                      "off_sum": off, "covered": covered, "gt1": gt1,
                      "skip": skip, "gt_hist": hist, "cov_hist": cov})
    for key, fill, names in (("gt1", 0, ("prev_gt", "next_gt")),
                             ("skip", False, ("prev_skip", "next_skip"))):
        for s, (before, after) in zip(steps, halo([s[key] for s in steps],
                                                  fill)):
            v = s[key]
            s[names[0]] = torch.cat([before, v[:-1]])
            s[names[1]] = torch.cat([v[1:], after])
    for s in steps:
        g = s["gt1"]
        s["cg_mask"] = (((g == 5) & (s["next_gt"] == 8))
                        | ((g == 8) & (s["prev_gt"] == 5)))
    keys = ("gt_prob", "max_gt", "margin", "off_sum", "covered", "gt1",
            "prev_gt", "next_gt", "prev_skip", "next_skip", "cg_mask")
    dev0 = devices[0]
    out = {k: gather([s[k] for s in steps], dev0) for k in keys}
    for k in ("gt_hist", "cov_hist"):
        out[k] = sum(s[k].to(dev0, non_blocking=True) for s in steps)
    return out


def sharded_call_step(devices, counts, quals, ref,
                      tables: Sequence[ModelTables]):
    """(gt_prob, max_gt, cg_mask, gt_hist, cov_hist) of
    `sharded_full_step`."""
    out = sharded_full_step(devices, counts, quals, ref, tables)
    return tuple(out[k] for k in ("gt_prob", "max_gt", "cg_mask", "gt_hist",
                                  "cov_hist"))
