"""Kernel seconds from the device's timeline as the profiler gives it,
from a stand-in for the profiler's events."""

import pytest

from portbench.trace import kernel_seconds


class _Event:
    def __init__(self, name, start, dur, on_card=True):
        self._n, self._s, self._d = name, start, dur
        self._t = "DeviceType.CUDA" if on_card else "DeviceType.CPU"

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_kernels_only():
    prof = _Prof([
        _Event("void pileup_genotype_kernel<double>", 0, 100),
        _Event("Memcpy HtoD (Pageable -> Device)", 50, 100),
        _Event("emit_fields_kernel", 300, 50),
        _Event("Memset (Device)", 400, 10),
        _Event("cudaLaunchKernel", 0, 10, on_card=False),
        # a host range the profiler also draws on the card's timeline
        _Event("portbench.anchor", 500, 5),
        _Event("portbench.anchor", 500, 5, on_card=False),
    ])
    assert kernel_seconds(prof) == pytest.approx(150e-9)


def test_no_device_events():
    assert kernel_seconds(_Prof([_Event("aten::mm", 0, 10, False)])) == 0.0
