#!/usr/bin/env python3
"""Where a kernel's time goes, on one NVIDIA GPU.

    python3 tools/kernel_phases.py k12 [--src LABEL=PATH ...]
    python3 tools/kernel_phases.py k3 [--src LABEL=PATH ...]
    python3 tools/kernel_phases.py k2 [--src LABEL=PATH ...] [--whole]

Run from the root of a checkout on a machine with a CUDA device and
nvcc. Builds one kernel source several times, each a variant cut at a
phase boundary, all nvcc runs started together, and times each with
`chip_smoke.device_ms` (CUDA graph replay, device time only).

k12, `bs_call_tpu_torch/csrc/pileup_genotype.cu`, on
`chip_smoke.k12_batches` over 32,832 positions: (a) `read_batch`, 4,096
random reads of up to 256 bases; (b) `wgbs_reads` at depth 18, 3,939
reads of 150 bases, sorted and padded to L = 160 (`prepare_batch`);
(b256) the same reads as the engine pads them (L = 256, a power-of-two
row count, `tile_rows`); hot, 5,000 reads over one position (f64 only).
f64 and f32:

* full: the kernel as it ships;
* pileup: stops after the tile's pileup planes are written;
* model: skips the read batch and runs the model on synthetic counts
  (0-5 a category, quality 30);
* launch: returns at once (the floor of one launch in a graph).

K12's cuts know both designs of `pileup_genotype.cu`: two threads a
position (the first) and a CTA of 16 warps a tile. Each version's ptxas
line carries its resident CTAs a SM (`cudaOccupancyMaxActiveBlocksPer
Multiprocessor`, at its block size and dynamic shared memory).

k3, `bs_call_tpu_torch/csrc/emit.cu`, on `chip_smoke.k3_batch`'s two
batches of 32,832 positions: (a) `genotype_inputs`, a het-rich random
mix, and (b) `wgbs_inputs`, WGBS-like at depth 18:

* full: the kernel as it ships;
* no_fisher: het forced false, so no Fisher walk runs;
* light: no Fisher and no GL (every GL slot the fixed -99.999, so
  neither the gt_prob gather nor the winner's band check runs);
* launch: returns at once.

Each K3 variant runs twice on each batch: with no ctx (the single-device
path: both chunk edges flagged, their outer neighbours uncalled) and with
ctx known (a position-sharded slab's: the codes of a CpG pair's two
halves just outside the chunk, read from a device int32 [2]). A source
from before ctx takes no such argument and ignores it, so its "ctx"
line times the same work as its plain one.

k2, `bs_call_tpu_torch/csrc/genotype.cu` (the column entry), in f64 and
f32, on `chip_smoke.column_inputs`'s two batches of 32,832 positions:
(a) `genotype_inputs`, het-rich, half the categories empty, and (b) the
column tier's counterpart of `wgbs_inputs` (covered rows only):

* full: the kernel as it ships;
* model: the model only, its ll written to gt_prob, no finish;
* finish: the finish on fixed ll (i-dependent values in [-48, 0]);
* launch: returns at once.

K2's cuts know both designs of `genotype.cu`: one thread a position (the
first) and a tile of positions a CTA.

The K3 and K2 cuts are edits of lines that every version of the source
has, so `--src` may name another version of the source, such as a parent
commit's unpacked with `git archive`. With several, each variant is
timed on every version in turns (A B B A), in one process on one card.
The variants' outputs are wrong by construction; only their times are
read. Prints one line per variant (and batch) with the card, and each
K3 batch's het share and risk count from the first version's full
kernel. For k2 and k12 with several versions it also says whether each
version's full outputs (K2's gt_prob, max_gt, margin, off_sum; K12's
pileup planes too) are bit-equal to the first version's, and where not,
on how many rows and by how much. `--whole` times each version as it is,
without the cuts: a way to compare design variants of one kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "bs_call_tpu_torch", "csrc")


def _cut(src: str, old: str, new: str) -> str:
    """src with its one occurrence of `old` (a regex) replaced by `new`."""
    out, k = re.subn(old, new, src)
    if k != 1:
        raise RuntimeError(f"{k} matches of {old!r}, expected one")
    return out


def k12_variants(src: str) -> dict:
    # synthetic counts (0-5 a category, quality 30) in place of the pileup
    model = (
        "  for (int j = tid; j < 16 * kStride; j += kThreads)\n"
        "    s_counts[j] = ((j * 7 + blockIdx.x) % 11) % 6;\n"
        "  for (int j = tid; j < 8 * kStride; j += kThreads)\n"
        "    s_qsum[j] = 30 * (((j * 7 + blockIdx.x) % 11) % 6);")
    if "two threads a position ----" in src:  # the parent: 2 a position
        model_cut = _cut(
            src, re.escape("const int n_batch = r1 > r0 ? (r1 - r0 + per - 1)"
                           " / per : 0;"),
            "const int n_batch = 0;\n" + model.replace("\\", "\\\\"))
        pileup = r"(?=  // ---- the model, two threads a position ----)"
    else:  # a CTA of 16 warps a tile, the model on K2's task split
        model_cut = _cut(src, r"const int n_stage = [^;]*;",
                         "const int n_stage = 0;")
        model_cut = _cut(model_cut, r"(?=  // ---- the pileup planes)",
                         model.replace("\\", "\\\\") + "\n  __syncthreads();\n")
        pileup = r"(?=  // ---- the model: )"
    return {
        "full": src,
        "pileup": _cut(src, pileup, "  return;\n"),
        "model": model_cut,
        "launch": _cut(src, r"(?=  const int tid = threadIdx\.x;\n)",
                       "  if (n_pos > 0) return;\n"),
    }


def k12_occupancy(src: str) -> str:
    """C source appended to a K12 variant: `kp_resident_ctas(f64)`, the
    CTAs of its kernel resident on one SM (the CUDA occupancy API), at
    its block size and dynamic shared memory."""
    dyn = "kDynSmem" if "kDynSmem" in src else "0"
    body = []
    for flag, t in ((1, "double"), (0, "float")):
        attr = ("" if dyn == "0" else
                f"cudaFuncSetAttribute(pileup_genotype_kernel<{t}>, "
                f"cudaFuncAttributeMaxDynamicSharedMemorySize, {dyn});\n    ")
        body.append(
            f"  if (f64 == {flag}) {{\n    {attr}"
            f"cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, "
            f"pileup_genotype_kernel<{t}>, kThreads, {dyn});\n  }}\n")
    return ("\nextern \"C\" int kp_resident_ctas(int f64) {\n"
            "  int n = -1;\n" + "".join(body) + "  return n;\n}\n")


_NO_HET = (re.escape("const bool het = covered && s_tab[kHet + mx];"),
           "const bool het = false;")
_NO_GL = (re.escape("const int idx = s_tab[kGlIdx + key * 5 + k];"),
          "const int idx = -2;")


def k3_variants(src: str) -> dict:
    no_fisher = _cut(src, *_NO_HET)
    return {
        "full": src,
        "no_fisher": no_fisher,
        "light": _cut(no_fisher, *_NO_GL),
        "launch": _cut(src, r"(emit_fields_kernel\([^)]*\)\s*\{)",
                       r"\1\n  if (n > 0) return;"),
    }


# K2's fixed ll for the finish cut, from the row index (`i` or `t0 + p`)
_FIXED_LL = ("for (int g = 0; g < kNG; ++g) "
             "ll[g] = T(-0.5 * (double)(({i} * 7 + g * 13) % 97));")


def k2_variants(src: str) -> dict:
    if "finish(ll, i, gt_prob" in src:  # one thread a position
        model = _cut(src, re.escape(
            "finish(ll, i, gt_prob, max_gt, margin, off_sum);"),
            "for (int g = 0; g < kNG; ++g) gt_prob[i * kNG + g] = ll[g];")
        finish = _cut(src, r"model\(nc, q, [^;]*;", _FIXED_LL.format(i="i"))
    else:  # a tile of positions a CTA, the phases spread over its warps
        acc = r"accumulate\(nc, [^;]*;"
        model = _cut(
            _cut(src, acc, r"\g<0>\n    for (int g = 0; g < kNG; ++g) "
                           r"gt_prob[(t0 + p) * kNG + g] = ll[g];"),
            r"(?=  // ---- the exponentials)", "  return;\n")
        # no log task runs, and every ll is a fixed value
        finish = _cut(_cut(src, acc, _FIXED_LL.format(i="(t0 + p)")),
                      r"task < kHalfTasks;", "task < 0;")
    return {
        "full": src,
        "model": model,
        "finish": finish,
        "launch": _cut(src, r"(genotype_column_kernel\([^)]*\)\s*\{)",
                       r"\1\n  if (n > 0) return;"),
    }


def build(versions: dict, variants, tmp: str, extra=None) -> dict:
    """{(label, variant): ctypes library}, one nvcc per library, all
    started together; each version's headers are the `.cuh` files beside
    its source. `extra(src)`, if given, is C source appended to each
    variant, and each version's full library then reports its resident
    CTAs a SM (`kp_resident_ctas`) beside its ptxas line."""
    from bs_call_tpu_torch.ops.kernels import _build

    nvcc = _build._nvcc()
    procs = {}
    for label, path in versions.items():
        with open(path) as f:
            src = f.read()
        for name, text in variants(src).items():
            d = os.path.join(tmp, label, name)
            os.makedirs(d)
            with open(os.path.join(d, "k.cu"), "w") as f:
                f.write(text + (extra(src) if extra else ""))
            for h in glob.glob(os.path.join(os.path.dirname(path), "*.cuh")):
                shutil.copy(h, d)
            procs[label, name] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                 os.path.join(d, "k.so"), os.path.join(d, "k.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
    libs = {}
    for key, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = ctypes.CDLL(os.path.join(tmp, *key, "k.so"))
        if key[1] == "full":
            regs = [ln.strip() for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln]
            if extra:
                regs.append("resident CTAs a SM: f64 %d, f32 %d" % (
                    libs[key].kp_resident_ctas(1),
                    libs[key].kp_resident_ctas(0)))
            print(f"{key[0]} ptxas: " + " | ".join(regs), flush=True)
    return libs


# the outputs whose bits `--src` versions are compared on, in the order
# the launchers return them
OUTPUTS = {
    "k2": ("gt_prob", "max_gt", "margin", "off_sum"),
    "k12": ("counts2", "qual_sum", "mapq2_sum", "gt_prob", "max_gt",
            "margin", "off_sum", "quals_u8"),
}


def bit_diff(torch, names, got, want) -> str:
    """Whether the outputs `got` are bit-equal to `want`'s, and where
    not, the rows and the largest difference of each output that
    differs."""
    parts = []
    for name, a, b in zip(names, got, want):
        bits = {1: torch.int8, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        ne = a.view(bits) != b.view(bits)
        if ne.any():
            rows = int((ne.view(a.shape[0], -1).any(1)).sum())
            d = (a.double() - b.double()).abs().max().item()
            parts.append(f"{name} differs on {rows} rows (max |d| {d:.3e})")
    return "; ".join(parts) or "bit-equal on every output"


def in_turns(labels, lib_of, timer, use):
    """{label: [ms, ...]}: `timer` on every version, in turns A B B A
    (one version: three times)."""
    order = labels + labels[::-1] if len(labels) > 1 else labels * 3
    times = {label: [] for label in labels}
    for label in order:
        use(lib_of(label))
        times[label].append(timer())
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("k12", "k3", "k2"))
    ap.add_argument("--src", action="append", default=[],
                    metavar="LABEL=PATH",
                    help="a version of the kernel's source (default: this "
                         "checkout's); repeat to time versions in turns")
    ap.add_argument("--whole", action="store_true",
                    help="time each version whole, without the phase cuts")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as S
    from bs_call_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device visible to PyTorch",
              file=sys.stderr)
        return 1
    fname = {"k12": "pileup_genotype.cu", "k3": "emit.cu",
             "k2": "genotype.cu"}[args.kernel]
    versions = dict(s.split("=", 1) for s in args.src) or {
        "checkout": os.path.join(CSRC, fname)}
    labels = list(versions)
    variants = {"k12": k12_variants, "k3": k3_variants,
                "k2": k2_variants}[args.kernel]
    if args.whole:
        def variants(src):
            return {"full": src}
    dev = torch.device("cuda", 0)
    card = S.card_line()
    tmp = tempfile.mkdtemp(prefix="kernel_phases_")
    try:
        libs = build(versions, variants, tmp,
                     k12_occupancy if args.kernel == "k12" else None)
        if args.kernel == "k12":
            from bs_call_tpu_torch.ops.kernels import (
                pileup_genotype_cuda as K,
            )
            from bs_call_tpu_torch.ops.params import (
                ModelParams,
                model_tables,
            )

            calls = {}
            for kind, (batch, tiles, ref) in S.k12_batches(
                    torch, np, dev).items():
                n = len(ref)
                for dtype in (torch.float64, torch.float32):
                    if kind == "hot" and dtype == torch.float32:
                        continue  # f32 off the main path: not at depth 5,000
                    tables = model_tables(ModelParams(), dtype, dev)
                    calls[f" {str(dtype)[6:]} batch {kind}"] = (
                        lambda b=batch, tl=tiles, r=ref, n=n, t=tables:
                        K.pileup_genotype(*b, tl, r, n, 20, t))
        elif args.kernel == "k2":
            from bs_call_tpu_torch.ops.kernels import genotype_cuda as K
            from bs_call_tpu_torch.ops.params import (
                ModelParams,
                model_tables,
            )

            calls = {}
            for kind in "ab":
                cols = [torch.from_numpy(a).to(dev)
                        for a in S.column_inputs(np, kind)]
                for dtype in (torch.float64, torch.float32):
                    tables = model_tables(ModelParams(), dtype, dev)
                    calls[f" {str(dtype)[6:]} batch {kind}"] = (
                        lambda c=cols, t=tables: K.genotype_column(*c, t))
        else:
            from bs_call_tpu_torch.ops.kernels import emit_cuda as K
            from bs_call_tpu_torch.ops.kernels import emit_device as E

            calls = {}
            ctx = torch.tensor([5, 8], dtype=torch.int32, device=dev)
            for kind in "ab":
                kargs = S.k3_batch(torch, np, dev, kind)[0]
                calls[f" batch {kind}"] = (
                    lambda a=kargs: K.emit_fields_cuda(*a))
                calls[f" batch {kind}, ctx"] = (
                    lambda a=kargs: K.emit_fields_cuda(*a, True, ctx))

        def use(lib):
            # point the launcher at this variant's library
            K._lib = None
            _build._lib = lib

        if args.kernel == "k3":
            use(libs[labels[0], "full"])
            for tag, call in calls.items():
                f = E.unpack_fields(call().cpu().numpy(), S.N_POS)
                print(f"[{card}] K3{tag}: het share "
                      f"{f['het'].mean():.4f} ({int(f['het'].sum())} of "
                      f"{S.N_POS}), risk {int(f['risk'].sum())} "
                      f"({labels[0]})", flush=True)
        if args.kernel in OUTPUTS:
            for tag, call in calls.items():
                outs = {}
                for label in labels:
                    use(libs[label, "full"])
                    outs[label] = call()
                torch.cuda.synchronize()
                for label in labels[1:]:
                    print(f"[{card}] {args.kernel.upper()}{tag}: {label} "
                          f"against {labels[0]}: " + bit_diff(
                              torch, OUTPUTS[args.kernel], outs[label],
                              outs[labels[0]]), flush=True)
        for name in [v for lb, v in libs if lb == labels[0]]:
            for tag, call in calls.items():
                times = in_turns(labels, lambda lb: libs[lb, name],
                                 lambda: S.device_ms(call, torch), use)
                cells = "; ".join(
                    f"{lb} " + ", ".join(f"{t:.4f}" for t in ts)
                    for lb, ts in times.items())
                print(f"[{card}] {args.kernel.upper()} {name}{tag}: {cells} ms",
                      flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
