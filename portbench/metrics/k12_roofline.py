"""K12's (`pileup_genotype_kernel`) share of its roofline over the window, from the device trace and `portbench/work/k12.py`."""

from portbench.metrics._roofline import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k12")
