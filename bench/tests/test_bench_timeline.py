"""The reduction of a trace to busy time, operations and idle stretches
(``bench/timeline.py``), on hand-made events."""

from __future__ import annotations

from bench import timeline as T

MS = 1_000_000


def _summary(host, dev, cuda=True, wrappers=()):
    tl = T.Timeline("cpu", {})
    tl.cuda = cuda
    tl.wrappers = {(None, w): w for w in wrappers}
    tl.events = (host, dev)
    return tl.summary()


def test_busy_is_the_union_and_gaps_are_named_by_the_host():
    host = [("bench.traced", 0, 100 * MS), ("bench.prefill 1024", 0, 60 * MS),
            ("aten::zeros", 10 * MS, 40 * MS), ("aten::mm", 50 * MS, 51 * MS)]
    dev = [("flash_fwd_mma_kernel", 5 * MS, 10 * MS),
           ("gemm", 8 * MS, 12 * MS), ("ssd_state_pass_kernel", 40 * MS,
                                        41 * MS),
           ("ssd_state_pass_kernel", 41 * MS + 5000, 42 * MS)]
    s = _summary(host, dev)
    assert abs(s["busy_s"] - (9 * MS - 5000) * 1e-9) < 1e-12
    assert s["window_s"] == 0.1
    assert abs(s["kernel_s"]["ssd_state_pass_kernel"] - 0.002 + 5e-6) < 1e-12
    gaps = dict(s["idle_gaps"])
    assert abs(gaps["bench.prefill 1024: aten::zeros"] - 0.028) < 1e-12
    assert gaps["between units: no host operation"] == 0.058
    assert abs(gaps["between kernels launched back to back"] - 5e-6) < 1e-12
    assert abs(gaps["bench.prefill 1024: no host operation"] - 0.005) < 1e-12


def test_on_the_cpu_wrapper_spans_and_outermost_operations_stand_in():
    host = [("bench.traced", 0, 10 * MS), ("_SSDScan", 1 * MS, 4 * MS),
            ("K5 ssd_scan_chunked", 1 * MS, 4 * MS),
            ("aten::einsum", 2 * MS, 3 * MS), ("aten::add", 5 * MS, 6 * MS),
            ("aten::mul", 5 * MS, 5 * MS + 500)]
    s = _summary(host, [], cuda=False, wrappers=("K5 ssd_scan_chunked",))
    assert set(s["kernel_s"]) == {"K5 ssd_scan_chunked", "aten::add"}
    assert abs(s["busy_s"] - 0.004) < 1e-12


def test_kernel_names_lose_their_signature():
    assert T._short("void ssd_chunk_scan_mma_kernel<64>(float const*, int)") \
        == "ssd_chunk_scan_mma_kernel"
    assert T._short("void (anonymous namespace)::flash_bwd_dq_mma_kernel<128>"
                    "(float const*)") == "flash_bwd_dq_mma_kernel"
    assert T._short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD "


class _Event:
    def __init__(self, name, device, start, end, kind=None):
        self._v = (name, device, start, end)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]


def test_the_devices_copies_of_annotations_are_left_out():
    with_kind = [_Event("bench.train step", "CPU", 0, 9, "user_annotation"),
                 _Event("aten::mm", "CPU", 1, 2, "cpu_op"),
                 _Event("bench.train step", "CUDA", 2, 8,
                        "gpu_user_annotation"),
                 _Event("void gemm<1>(int)", "CUDA", 2, 4, "kernel"),
                 _Event("Memset (Device)", "CUDA", 4, 5, "gpu_memset")]
    without = [_Event(*e._v) for e in with_kind]
    for raw in (with_kind, without):
        host, dev = T._split(raw)
        assert [n for n, _, _ in host] == ["bench.train step", "aten::mm"]
        assert dev == [("gemm", 2, 4), ("Memset ", 4, 5)]
