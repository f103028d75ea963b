"""The metric arithmetic: a rate over the whole window, a percentile over
every step, time on the device from the union of intervals, and the
trace's charging of device operations to the host spans."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import readers, stats, trace


def window(batches, seconds):
    return {"batches": batches, "seconds": seconds,
            "tokens": sum(b["tokens"] for b in batches)}


def batch(ttft, steps, tokens=None, launch=None):
    return {"ttft": ttft, "steps": list(steps),
            "positions": list(range(len(steps))),
            "launch": list(launch if launch is not None else steps),
            "tokens": tokens if tokens is not None else 4 * (1 + len(steps))}


def test_rate_is_over_the_whole_window():
    # 2 batches of 4 requests, 5 tokens each = 40 tokens in a 10 s window,
    # however long the prefills took
    run = SimpleNamespace(window=window(
        [batch(1.0, [0.1] * 4), batch(1.0, [0.1] * 4)], 10.0))
    assert readers.tok_s(run) == pytest.approx(4.0)
    assert readers.ttft_ms(run) == pytest.approx(1000.0)


def test_p95_is_over_every_step_and_a_stall_moves_it():
    steps = [0.010] * 190
    run = SimpleNamespace(window=window([batch(0.5, steps)], 5.0))
    assert readers.itl_p95_ms(run) == pytest.approx(10.0)
    # eleven stalls of 50 ms among 200 steps: more than 5 % of them
    stalled = steps[:95] + [0.050] * 11 + steps[95:]
    run = SimpleNamespace(window=window([batch(0.5, stalled)], 5.0))
    assert readers.itl_p95_ms(run) == pytest.approx(50.0)
    # the same stalls spread over two batches move it the same
    run = SimpleNamespace(window=window(
        [batch(0.5, stalled[:100]), batch(0.5, stalled[100:])], 5.0))
    assert readers.itl_p95_ms(run) == pytest.approx(50.0)


def test_percentile_matches_statistics_quantiles():
    vals = [float(v) for v in range(1, 101)]
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_busy_time_counts_overlapping_intervals_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert stats.busy(iv, 0.0, 10.0) == pytest.approx(4.0)
    # a sum of durations would read 5.2 and an idle share below zero
    assert sum(b - a for a, b in iv) == pytest.approx(5.2)
    assert stats.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert stats.busy(iv, 1.5, 5.5) == pytest.approx(2.0)


class Ev:
    """A kineto event as ``trace.summarize`` reads it."""

    def __init__(self, name, device, start, dur, corr=0, kind=""):
        self._v = (name, device, start, dur, corr, kind)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]


def synthetic_trace():
    import torch
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ms = 1_000_000
    return [
        Ev("pb.prefill", CPU, 0, 10 * ms, kind="user_annotation"),
        Ev("cudaGraphLaunch", CPU, 1 * ms, 10_000, 7, "cuda_runtime"),
        Ev("pb.decode", CPU, 20 * ms, 2 * ms, kind="user_annotation"),
        Ev("cudaGraphLaunch", CPU, 21 * ms, 10_000, 8, "cuda_runtime"),
        Ev("pb.next_token", CPU, 22 * ms, 8 * ms, kind="user_annotation"),
        Ev("cudaLaunchKernel", CPU, 23 * ms, 10_000, 9, "cuda_runtime"),
        # prefill replay: a product overlapping an elementwise kernel
        Ev("void wgmma_gemm_kernel<0>", CUDA, 2 * ms, 4 * ms, 7, "kernel"),
        Ev("elementwise_kernel", CUDA, 5 * ms, 3 * ms, 7, "kernel"),
        # decode replay, then the harness's argmax
        Ev("void splitk_decode_kernel<16>", CUDA, 22 * ms, 2 * ms, 8,
           "kernel"),
        Ev("copy_kernel", CUDA, 24 * ms, 1 * ms, 8, "kernel"),
        Ev("argmax_kernel", CUDA, 26 * ms, 1 * ms, 9, "kernel"),
        Ev("pb.decode", CUDA, 22 * ms, 3 * ms, kind="gpu_user_annotation"),
    ]


def test_trace_charges_device_operations_to_the_launching_span():
    s = trace.summarize(synthetic_trace())
    assert s.window == pytest.approx((0.0, 0.030))
    assert s.count("decode") == 1 and s.count("prefill") == 1
    dec = s.replay_ops("decode")
    assert sorted(o.name for o in dec) == ["copy_kernel",
                                           "void splitk_decode_kernel<16>"]
    assert [o.name for o in s.ops if o.span == "next_token"] == \
        ["argmax_kernel"]
    # the annotation mirrored on the device is no operation; the two
    # overlapping prefill kernels count once: 2..8, 22..25, 26..27 ms
    assert s.busy_s == pytest.approx(0.010)
    names = dict((k.split(":")[0], v) for k, v in s.idle_by_span())
    # gaps 0..2 (prefill), 8..22 (its middle between spans), 25..26 and
    # 27..30 (the host waiting in next_token)
    assert names["prefill"] == pytest.approx(0.002)
    assert names["between spans"] == pytest.approx(0.014)
    assert names["next_token"] == pytest.approx(0.004)


def test_readers_take_per_replay_device_time_and_rooflines():
    from portbench import counts
    s = trace.summarize(synthetic_trace())
    ref = SimpleNamespace(launches=lambda dm, b, p, phase: {
        "spm_matmul": [counts.Cost(0.0, 3.35e12 * 1e-3)]})
    run = SimpleNamespace(trace=s, ctx=SimpleNamespace(
        workload={"batch": 1, "prompt_len": 1}, dims={}, reference=ref))
    assert readers.device_ms_per_replay(run, "decode", None) == \
        pytest.approx(1.0)
    assert readers.device_ms_per_replay(run, "prefill", "spm_matmul") == \
        pytest.approx(4.0)
    # a bound of 1 ms over 2 ms of splitk time
    assert readers.roofline(run, "spm_matmul", "decode") == \
        pytest.approx(50.0)
    assert readers.roofline(run, "flash_attention", "prefill") is None
    assert readers.idle_share(run) == pytest.approx(100 * (1 - 10 / 30))


def test_host_time_is_the_launch_inside_the_step():
    run = SimpleNamespace(window=window(
        [batch(0.1, [0.010, 0.012], launch=[0.0009, 0.0011]),
         batch(0.1, [0.020, 0.020], launch=[0.0005, 0.0015])], 1.0))
    # over every step of the window: (0.9 + 1.1 + 0.5 + 1.5) / 4 ms
    assert readers.host_ms_decode(run) == pytest.approx(1.0)


def test_a_replay_whose_launch_was_dropped_is_left_out():
    import torch
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ms = 1_000_000
    events = synthetic_trace() + [
        # a second decode replay: its kernels are there, its launch is not
        Ev("pb.decode", CPU, 40 * ms, 2 * ms, kind="user_annotation"),
        Ev("void splitk_decode_kernel<16>", CUDA, 41 * ms, 2 * ms, 12,
           "kernel"),
        Ev("copy_kernel", CUDA, 43 * ms, 1 * ms, 12, "kernel")]
    s = trace.summarize(events)
    assert s.count("decode") == 2 and s.replays("decode") == 1
    run = SimpleNamespace(trace=s)
    assert readers.device_ms_per_replay(run, "decode", None) == \
        pytest.approx(1.0)
    assert readers.device_ms_per_replay(run, "decode", "spm_matmul") == \
        pytest.approx(2.0)


def test_window_closes_at_a_batch_end(monkeypatch):
    import time

    import torch

    from conftest import tiny_cell
    from portbench import harness
    from portbench.traffic import batch_serve
    monkeypatch.setattr(batch_serve, "WARMUP_S", 0.2)
    ctx = harness.context(tiny_cell("rwkv"), 2**33 + 9, torch.device("cpu"))
    t0 = time.perf_counter()
    ctx.kind.prepare(ctx)
    w = ctx.workload
    # the warm-up served batches for WARMUP_S, one at least
    assert ctx.warmup and time.perf_counter() - t0 >= 0.2
    rec = ctx.kind.window(ctx, 0.3, None)
    ends = [b["end"] - rec["start"] for b in rec["batches"]]
    # every batch is whole; only the last ends past the window's seconds,
    # and the window is as long as its batches took
    assert all(len(b["steps"]) == w["gen"] - 1 for b in rec["batches"])
    assert all(e < 0.3 for e in ends[:-1]) and ends[-1] >= 0.3
    assert rec["seconds"] == pytest.approx(ends[-1])
    assert rec["tokens"] == len(ends) * w["batch"] * w["gen"]
    assert readers.tok_s(SimpleNamespace(window=rec)) == \
        pytest.approx(rec["tokens"] / ends[-1])

