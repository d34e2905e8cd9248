"""The trace reduction on a made-up profile: busy time is the union of
device intervals clipped to the window, annotations do not count, gaps
are named by the host call they fall in; and the scan's kernel names are
read from its source."""
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from listbench import trace

ROOT = Path(__file__).resolve().parents[2]


class Event:
    def __init__(self, start, end, name, device=True, kind="kernel"):
        self._s, self._e, self._n = start, end, name
        self._d = DeviceType.CUDA if device else DeviceType.CPU
        self._k = kind

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def activity_type(self):
        return self._k


class Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})()})()


def test_busy_gaps_and_names():
    evs = [Event(0, 30, "early"),                       # clipped at 10
           Event(20, 40, "void k1<int>(int)"),
           Event(30, 50, "Memcpy DtoH (Device -> Pinned)", kind="gpu_memcpy"),
           Event(10, 110, "annotation", kind="gpu_user_annotation"),
           Event(70, 90, "(anonymous namespace)::k2(int)"),
           Event(55, 65, "cudaStreamSynchronize", device=False)]
    s = trace.reduce(Profile(evs), (10, 110))
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["busy_s"] == pytest.approx(60e-9)       # 10–50 and 70–90
    assert s["n_kernels"] == 3
    gaps = dict(s["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-9)
    assert gaps[trace.OUTSIDE] == pytest.approx(20e-9)
    assert "annotation" not in s["device_s_by_name"]


def test_scan_kernel_names_from_the_source():
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
           "fused_topk_score.cu").read_text()
    names = trace.kernel_names(src)
    assert {"engine_scan_kernel", "merge_kernel", "items_kernel"} <= names
    assert trace.function_name(
        "void (anonymous namespace)::engine_scan_kernel<signed char, false,"
        " 16>(CUtensorMap_st, (anonymous namespace)::ScanArgs, ") \
        == "engine_scan_kernel"
    assert trace.function_name(
        "void at::native::elementwise_kernel<128, 4>(int)") \
        == "elementwise_kernel"
