#!/usr/bin/env python3
"""Where K12's time goes, on one NVIDIA GPU.

    python3 tools/k12_phases.py

Run from the root of a checkout on a machine with a CUDA device and
nvcc. Builds `bs_call_tpu_torch/csrc/pileup_genotype.cu` four times, each
a variant cut at a phase boundary, and times each on `chip_smoke.py`'s
K1 batch (4,096 reads x 256 bases over 32,832 positions, f64) with
`chip_smoke.device_ms` (CUDA graph replay, device time only):

* full: the kernel as it ships;
* pileup: stops after the tile's pileup planes are written;
* model: skips the read batch and runs the model on synthetic counts
  (0-5 a category, quality 30);
* launch: returns at once (the floor of one launch in a graph).

The variants' outputs are wrong by construction; only their times are
read. Prints one line per variant and the card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "bs_call_tpu_torch", "csrc")


def variants(src: str) -> dict:
    def cut(marker, insert):
        if marker not in src:
            raise RuntimeError(f"marker not found: {marker!r}")
        return src.replace(marker, insert + marker, 1)

    out = {
        "full": src,
        "pileup": cut("  // ---- the model, two threads a position ----",
                      "  return;\n"),
        "model": src.replace(
            "const int n_batch = r1 > r0 ? (r1 - r0 + per - 1) / per : 0;",
            "const int n_batch = 0;\n"
            "  for (int j = tid; j < 16 * kStride; j += kThreads)\n"
            "    s_counts[j] = ((j * 7 + blockIdx.x) % 11) % 6;\n"
            "  for (int j = tid; j < 8 * kStride; j += kThreads)\n"
            "    s_qsum[j] = 30 * (((j * 7 + blockIdx.x) % 11) % 6);", 1),
        "launch": cut("  const int tid = threadIdx.x;\n",
                      "  if (n_pos > 0) return;\n"),
    }
    if out["model"] == src:
        raise RuntimeError("marker not found: n_batch")
    return out


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as S
    from bs_call_tpu_torch.ops.kernels import _build
    from bs_call_tpu_torch.ops.kernels import pileup_device as PD
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12
    from bs_call_tpu_torch.ops.params import ModelParams, model_tables

    if not torch.cuda.is_available():
        print("k12_phases: no CUDA device visible to PyTorch",
              file=sys.stderr)
        return 1
    with open(os.path.join(CSRC, "pileup_genotype.cu")) as f:
        src = f.read()
    tmp = tempfile.mkdtemp(prefix="k12_phases_")
    try:
        nvcc = _build._nvcc()
        procs = {}
        for name, text in variants(src).items():
            d = os.path.join(tmp, name)
            os.makedirs(d)
            with open(os.path.join(d, "k.cu"), "w") as f:
                f.write(text)
            for h in _build.headers():
                shutil.copy(h, d)
            procs[name] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                 os.path.join(d, "k.so"), os.path.join(d, "k.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        libs = {}
        for name, proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                print(out, file=sys.stderr)
                return 1
            libs[name] = ctypes.CDLL(os.path.join(tmp, name, "k.so"))

        dev = torch.device("cuda", 0)
        n = S.N_POS
        batch = S.read_batch(np, 4096, 256, n, 1)
        R, L = batch[0].shape
        tiles = torch.from_numpy(PD.tile_rows(batch[1], R, n, L)).to(dev)
        args = [torch.from_numpy(a).to(dev) for a in batch]
        ref = torch.from_numpy(
            np.random.default_rng(4).integers(0, 5, n).astype(np.int32)
        ).to(dev)
        tables = model_tables(ModelParams(), torch.float64, dev)
        card = S.card_line()
        for name, lib in libs.items():
            # point K12's launcher at this variant's library
            K12._lib = None
            _build._lib = lib
            times = [S.device_ms(lambda: K12.pileup_genotype(
                *args, tiles, ref, n, 20, tables), torch) for _ in range(3)]
            print(f"[{card}] K12 {name}: "
                  + ", ".join(f"{t:.4f}" for t in times) + " ms",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
