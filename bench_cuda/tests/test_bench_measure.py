"""The rate and tail arithmetic, the trace reductions and the readers."""

import pytest

from bench_cuda import measure, roofline, spec
from bench_cuda.harness import Run


def test_percentile_is_nearest_rank_over_every_value():
    vals = list(range(1, 101))
    assert measure.percentile(vals, 95) == 95
    assert measure.percentile(vals, 100) == 100
    assert measure.percentile([5.0], 95) == 5.0
    # one slow query in twenty is the 95th percentile's own
    assert measure.percentile([1.0] * 19 + [9.0], 95) == 1.0
    assert measure.percentile([1.0] * 18 + [9.0] * 2, 95) == 9.0
    with pytest.raises(ValueError):
        measure.percentile([], 95)


def test_rate_is_all_the_work_over_all_the_window():
    assert measure.rate(17_825_792, 1517, 5.002) == pytest.approx(
        17_825_792 * 1517 / 5.002)
    assert measure.median([3, 1, 2]) == 2
    assert measure.median([4, 1, 2, 3]) == 2.5


def test_busy_is_the_union_of_intervals():
    assert measure.busy_us([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert measure.busy_us([]) == 0


def test_kernel_names_match_whole_words_or_prefixes():
    k1 = ("void (anonymous namespace)::radix_scatter<2>((anonymous "
          "namespace)::Plan, (anonymous namespace)::Bufs, unsigned int "
          "const*)")
    assert measure.kernel_matches(k1, ["radix_scatter"])
    assert not measure.kernel_matches(k1, ["radix_scan"])
    assert not measure.kernel_matches("gather_kernel_db(int*)",
                                      ["gather_kernel"])
    assert measure.kernel_matches("ncclDevKernel_SendRecv(...)", ["nccl*"])
    assert not measure.kernel_matches("my_nccl_like", ["nccl*"])


def test_roofline_work_from_shapes():
    # the port's K1 and K2 bounds (PERF.md's kernel table) count the same
    assert roofline.sort_bytes(1 << 24) == 201_326_592
    assert roofline.lookup_bytes(1 << 20, 1 << 24) == 138_412_032
    rows = {"R": 1 << 20, "S": 1 << 24}
    assert roofline.op_bytes("lookup", {"table": "R", "keys": "S"},
                             rows) == 138_412_032
    assert measure.bound_ms(3.35e9) == pytest.approx(1.0)


def _run(**kw):
    base = dict(config={"rows": {"R": 10, "S": 90}},
                traffic={"rows": ["R", "S"]}, world=1, queries=50,
                window_s=2.0, setup_s=7.5,
                latencies_s=[0.01] * 40 + [0.02] * 10, peak_bytes=2 ** 31)
    base.update(kw)
    return Run(**base)


def test_end_to_end_readers():
    run = _run()
    read = {n: spec.module("metrics", n).read(run)
            for n in ("rows_per_s", "query_ms_p95", "device_mem_peak_gib",
                      "setup_s")}
    assert read == {"rows_per_s": 100 * 50 / 2.0, "query_ms_p95": 20.0,
                    "device_mem_peak_gib": 2.0, "setup_s": 7.5}
    assert spec.module("metrics", "device_mem_peak_gib").read(
        _run(peak_bytes=0)) is None


def test_per_layer_readers_read_what_is_there():
    tr = measure.Trace(queries=4, window_s=0.1, busy_s=0.06,
                       device_ops={"radix_scatter<2>(x)": (0.002, 8),
                                   "gather_kernel(int*)": (0.0004, 4),
                                   "ncclDevKernel_AllToAll": (0.004, 4)},
                       host_reads=24)
    run = _run(trace=tr, busy=[(0.06, 0.1), (0.08, 0.1)],
               phase_ms={"build": [1.0, 3.0, 2.0]},
               config={"rows": {"R": 1 << 20, "S": 1 << 24}},
               traffic={"rows": ["R", "S"], "ops": {
                   "probe_sort": {"keys": "S", "kernels": ["radix_scatter"]},
                   "lookup": {"table": "R", "keys": "S",
                              "kernels": ["gather_kernel"]},
                   "collective": {"kernels": ["nccl*"]}}})

    def read(n):
        return spec.module("metrics", n).read(run)

    assert read("build_ms") == 2.0
    assert read("probe_ms") is None
    assert read("host_syncs_per_query") == 6
    assert read("device_idle_pct") == pytest.approx(30.0)
    assert read("collective_ms") == pytest.approx(1.0)
    assert read("probe_sort_roofline_pct") == pytest.approx(
        100 * measure.bound_ms(201_326_592) / 0.5)
    assert read("lookup_roofline_pct") == pytest.approx(
        100 * measure.bound_ms(138_412_032) / 0.1)
    bare = _run()
    for n in ("host_syncs_per_query", "device_idle_pct", "collective_ms",
              "probe_sort_roofline_pct", "lookup_roofline_pct"):
        assert spec.module("metrics", n).read(bare) is None


def test_idle_gaps_are_named_by_the_host_call_running_through_them():
    spans = [(0, 100, "outer"), (10, 20, "a"), (30, 60, "b"),
             (40, 50, "c")]
    assert measure._innermost([5, 15, 25, 45, 55, 150], spans) == [
        "outer", "a", "outer", "c", "b", "(between host calls)"]


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, start, end, cuda, thread=1, annotation=False):
        from torch.autograd import DeviceType

        self.name, self.thread = name, thread
        self.time_range = _Range(start, end)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.is_user_annotation = annotation


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_a_trace_reduces_to_busy_time_operations_reads_and_gaps():
    prof = _Prof([
        _Event("radix_scatter<2>(Plan)", 0, 100, True),
        _Event("Memcpy DtoH (Device -> Pageable)", 150, 160, True),
        _Event("ncclDevKernel_SendRecv(args)", 200, 300, True),
        _Event("nccl:all_to_all", 190, 310, True, annotation=True),
        _Event("nccl:all_reduce", 320, 330, True),  # unflagged annotation
        _Event("aten::sort", 0, 140, False),
        _Event("cudaStreamSynchronize", 100, 145, False),
        _Event("cudaMemcpy", 150, 161, False),
        _Event("aten::add", 165, 195, False),
    ])
    tr = measure.reduce_profile(prof, queries=2, window_s=0.001)
    assert tr.busy_s == pytest.approx(210e-6)
    assert set(tr.device_ops) == {"radix_scatter<2>(Plan)",
                                  "Memcpy DtoH (Device -> Pageable)",
                                  "ncclDevKernel_SendRecv(args)"}
    assert tr.kernel_s(["nccl*"]) == pytest.approx(100e-6)
    assert tr.host_reads == 2
    assert tr.idle_gaps == pytest.approx({"cudaStreamSynchronize": 50e-6,
                                          "aten::add": 40e-6})
