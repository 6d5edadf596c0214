"""The trace reading on a synthetic event list: the device's busy union, each
operation's spans by its launch, the idle gaps and their host phase."""

import torch

from port_bench import trace


class Ev:
    def __init__(self, name, start, end, corr=0, device=False):
        self._n, self._s, self._e, self._c, self._d = name, start, end, corr, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU


def test_busy_us_unions_overlaps():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.busy_us([]) == 0
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def events():
    """Two steps of 100 ns; the first is skipped. In step 2: upload at 100,
    the entry 110-170 holding the net 120-165, whose neck runs 140-160 with
    head 150-160."""
    ev = []
    for base in (0, 100):
        ev += [Ev("pb:step", base, base + 100), Ev("pb:upload", base, base + 10), Ev("pb:entry", base + 10, base + 70),
               Ev("pb:net", base + 20, base + 65), Ev("pb:encoder", base + 25, base + 38), Ev("pb:neck", base + 40, base + 60),
               Ev("pb:reassemble.0", base + 40, base + 45), Ev("pb:head", base + 50, base + 60),
               Ev("pb:readback", base + 70, base + 72), Ev("pb:sync", base + 72, base + 100)]
    # (name, launch, start, end): copy, prep, encoder kernel, an attention kernel, head kernel, read-back copy
    kernels = [("Memcpy HtoD", 101, 105, 112), ("upsample_bilinear", 115, 120, 130), ("nvjet_gemm", 126, 130, 150),
               ("fa_sm90<bf16>", 130, 150, 160), ("conv_head", 155, 160, 175), ("Memcpy DtoH", 171, 180, 185)]
    for i, (name, launch, s, e) in enumerate(kernels):
        ev += [Ev("cudaLaunchKernel", launch, launch + 1, corr=1000 + i), Ev(name, s, e, corr=1000 + i, device=True)]
    ev.append(Ev("fa_sm90<bf16>", 40, 50, corr=999, device=True))  # in the skipped step: no runtime call, outside
    return ev


def test_read_attributes_by_launch_and_finds_gaps():
    rec = trace.read(events(), frames_per_step=2, skip_steps=1)
    assert rec.steps == 1 and rec.frames == 2 and rec.stretch == (100, 200)
    spans = {o.name: o.spans for o in rec.ops}
    assert "upload" in spans["Memcpy HtoD"] and "entry" not in spans["Memcpy HtoD"]
    assert "entry" in spans["upsample_bilinear"] and "net" not in spans["upsample_bilinear"]
    assert {"net", "encoder"} <= spans["nvjet_gemm"] and "neck" not in spans["nvjet_gemm"]
    assert {"net", "encoder"} <= spans["fa_sm90<bf16>"]
    assert {"neck", "head"} <= spans["conv_head"]
    assert "readback" in spans["Memcpy DtoH"]
    # busy: 105-112, 120-175, 180-185 = 7 + 55 + 5
    assert abs(rec.busy_s - 67e-9) < 1e-15
    assert rec.unmatched == 1
    gaps = [(label, round(s * 1e9)) for label, s in rec.gaps]
    # 185-200 while the host syncs, 112-120 in the facade call, 100-105 uploading, 175-180 syncing
    assert gaps == [("sync", 15), ("enqueue", 8), ("upload", 5), ("sync", 5)]


def test_breakdown_lists_ops_and_gaps():
    b = trace.breakdown(trace.read(events(), 2))
    assert b["device_ops"][0][0] == "nvjet_gemm" and abs(b["device_ops"][0][1] - 20e-9) < 1e-15
    assert len(b["device_ops"]) <= trace.BREAKDOWN_ENTRIES and len(b["idle_gaps"]) <= trace.BREAKDOWN_ENTRIES


def test_metric_readers_on_synthetic_trace():
    from port_bench import spec
    from port_bench.cell import Record, Window

    rec = trace.read(events(), 2)
    window = Window(frames=10, steps=5, seconds=2.0, request_s=[0.1] * 5, enqueue_s=[0.02] * 5, peak_bytes=2**30, begin=0.0)
    counts = {"model_flops_per_frame": 989e12 * 0.05, "attention": {"bound_s": 5e-9}}
    cell = spec.Cell({"name": "x"}, {"dtype": "bfloat16"}, {}, {})
    r = Record(cell, counts, 3.0, window, rec)
    read = {n: spec.metric_reader(n).read(r) for n in ("facade.prep_device_ms", "encoder.device_ms", "neck.device_ms",
                                                        "attention.roofline_pct", "device.idle_pct", "device.mfu_pct",
                                                        "facade.host_enqueue_ms", "frames_per_s", "peak_mem_gib", "setup_s")}
    assert abs(read["facade.prep_device_ms"] - 10e-9 * 1e3 / 2) < 1e-15
    assert abs(read["encoder.device_ms"] - 30e-9 * 1e3 / 2) < 1e-15  # the GEMM and the attention kernel
    assert abs(read["neck.device_ms"] - 15e-9 * 1e3 / 2) < 1e-15
    assert abs(read["attention.roofline_pct"] - 50.0) < 1e-9  # 5 ns bound over 10 ns
    assert abs(read["device.idle_pct"] - 33.0) < 1e-9
    assert abs(read["device.mfu_pct"] - 0.05 * 10 / 2.0 * 100) < 1e-9
    assert abs(read["facade.host_enqueue_ms"] - 20.0) < 1e-9
    assert read["frames_per_s"] == 5.0 and read["peak_mem_gib"] == 1.0 and read["setup_s"] == 3.0
