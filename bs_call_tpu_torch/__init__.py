"""bs_call_tpu_torch — the bisulfite caller's device tiers in PyTorch and
hand-written CUDA for NVIDIA Hopper (sm_90a).

A port of `bs_call_tpu`'s accelerator path. The host side (native C++
ingest and pileup, VCF/BCF emission, JSON report, scalar oracles) is
imported from `bs_call_tpu` and never copied, so both packages write the
same bytes from the same host code. This package imports `torch` and
never `jax`.

Entry point: `python -m bs_call_tpu_torch.cli ... --device {cuda,cpu}`.
"""

__version__ = "0.1.0"
