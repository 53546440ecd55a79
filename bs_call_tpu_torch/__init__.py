"""bs_call_tpu_torch — the bisulfite caller's device tiers in PyTorch and
hand-written CUDA for NVIDIA Hopper (sm_90a).

A port of `bs_call_tpu`'s accelerator path that stands alone: it keeps
its own copy of the host side it runs (the native C++ ingest, pileup,
model, emit and format library, the VCF/BCF/VCF.gz writers, the JSON
report, the scalar oracles), under the same module names, and imports
nothing of `bs_call_tpu` and never `jax`. The tests import both packages
and hold the port's bytes to the JAX package's.

Entry point: `python -m bs_call_tpu_torch.cli ... --device {cuda,cpu}`.
"""

__version__ = "0.1.0"
