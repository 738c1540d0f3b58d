"""The reduction of a profiler trace, on a hand-made one."""
import pytest

from bench import trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _device_stretch():
    return [
        _x("kernel", "void i1e_kernel", 0.0, 1.0, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 5.0, 1.0, correlation=2),
        _x("kernel", "split_kernel<bf16, true>", 10.0, 10.0, correlation=2),
        _x("kernel", "nvjet_tst_gemm", 15.0, 15.0, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 50.0, 10.0, correlation=4),
        _x("cuda_driver", "cuCtxSynchronize", -500.0, 1.0, correlation=9),
        _x("kernel", "void i1e_kernel", 99.0, 1.0, correlation=5),
    ]


def test_a_device_stretch_runs_between_its_markers():
    tr = trace.reduce(_device_stretch())
    assert (tr.t0, tr.t1) == (0.0, 100.0)
    assert [op[0] for op in tr.ops] == ["split_kernel<bf16, true>",
                                        "nvjet_tst_gemm", "Memcpy DtoH"]
    assert trace.busy_s(tr) == pytest.approx(30e-6)
    assert tr.window_s == pytest.approx(100e-6)
    ops = dict(trace.device_ops(tr))
    assert ops["nvjet_tst_gemm"] == pytest.approx(15e-6)
    assert [op[0] for op in trace.ops_named(tr, ("gemm",))] == \
        ["nvjet_tst_gemm"]


def test_a_host_stretch_attributes_idle_and_launches_to_phases():
    ev = [
        _x("user_annotation", "symbench/traced", 0.0, 100.0),
        _x("user_annotation", "repro_torch.obs/prefill", 0.0, 40.0),
        _x("user_annotation", "repro_torch.obs/jit_dispatch", 1.0, 9.0),
        _x("user_annotation", "repro_torch.obs/scatter", 70.0, 20.0),
        _x("cuda_runtime", "cudaLaunchKernel", 2.0, 1.0, correlation=7),
        _x("cuda_runtime", "cudaLaunchKernel", 60.0, 1.0, correlation=8),
        _x("kernel", "a", 10.0, 20.0, correlation=7),
        _x("kernel", "b", 60.0, 5.0, correlation=8),
    ]
    tr = trace.reduce(ev)
    assert [op[0] for op in trace.launched_in(tr, "prefill")] == ["a"]
    gaps = dict(trace.idle_gaps(tr))
    # 0-10 inside jit_dispatch (innermost), 30-60 split at 45 -> harness,
    # 65-100 midpoint 82.5 in scatter
    assert gaps["host:jit_dispatch"] == pytest.approx(10e-6)
    assert gaps["host:harness"] == pytest.approx(30e-6)
    assert gaps["host:scatter"] == pytest.approx(35e-6)


def test_a_device_stretch_whose_opening_marker_was_missed():
    tr = trace.reduce(_device_stretch()[1:])
    assert (tr.t0, tr.t1) == (10.0, 100.0)


def test_a_trace_without_its_range_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce(_device_stretch()[1:-1])


def test_the_training_cells_device_readers_on_a_hand_made_stretch():
    from types import SimpleNamespace

    from bench import manifest
    run = SimpleNamespace(trace=trace.reduce(_device_stretch()))
    # busy 10-30 and 50-60 of a 100-us stretch; the product 15 of 35 us
    for name in ("device_idle_pct.train", "device_idle_pct.train_moe"):
        assert manifest.reader(name)(run) == pytest.approx(70.0)
    for name in ("train_matmul_share_pct", "train_matmul_share_pct.moe"):
        assert manifest.reader(name)(run) == pytest.approx(100 * 15 / 35)
    assert manifest.reader("device_idle_pct")(
        SimpleNamespace(trace=None)) is None


def test_a_suffix_without_a_file_of_its_own_reads_with_the_base_name():
    from bench import manifest
    assert manifest.reader("device_idle_pct.any_suffix") is \
        manifest.reader("device_idle_pct")
    with pytest.raises(KeyError):
        manifest.reader("no_such_metric")


def test_the_serving_readers_on_a_tiny_open_loop_run():
    import tiny
    from bench import flops, manifest
    mix = tiny.serve_mix("serve_open")
    w, res, _ = manifest.loop(mix).run(
        tiny.arch("granite-3-8b"), mix, "tiny-serve-open", 6, 1.5, False,
        "cpu", lambda m: None, reference=False)
    w.peak = flops.peaks("NVIDIA H100 80GB HBM3")
    assert res["attempted"] > 5 and res["failed"] == 0
    for name in ("ttft_p90_ms", "tpot_p90_ms", "serve_tokens_per_s",
                 "queue_wait_p90_ms", "decode_tick_ms", "serve_mfu_pct"):
        value = manifest.reader(name)(w)
        assert value is not None and value > 0, name
    # untraced: the device-trace readers find nothing to read
    for name in ("decode_attn_roofline", "prefill_device_ms_per_ktok",
                 "device_idle_pct"):
        assert manifest.reader(name)(w) is None, name
