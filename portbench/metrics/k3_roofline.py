"""K3's (`emit_fields_kernel`) share of its roofline over the window, from the device trace and `portbench/work/k3.py`."""

from portbench.metrics._roofline import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k3")
