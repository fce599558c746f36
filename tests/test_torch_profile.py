"""The train-step profiler's trace summary (cli/profile_train.py) on a
hand-made chrome trace: step window, idle share, categories, launches."""

import pytest

from youku_mplug_tpu_torch.cli import profile_train as pt


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace():
    """Two 1000 us steps; kernels overlap on two streams in step 1; a
    memcpy in step 2; a kernel before the window is ignored."""
    return [
        _x("user_annotation", "train_step", 1000, 1000),
        _x("user_annotation", "train_step", 2000, 1000),
        _x("user_annotation", "Optimizer.step#AdamW.step", 1800, 100),
        _x("gpu_user_annotation", "train_step", 1000, 1000),
        _x("cpu_op", "aten::mm", 1000, 500),
        _x("kernel", "flash_fwd_kernel(bf16 const*)", 500, 100),
        _x("kernel", "(anonymous namespace)::flash_fwd_kernel(bf16 const*)",
           1100, 200),
        _x("kernel", "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", 1200, 300),
        _x("kernel", "cutlass_80_simt_sgemm_256x128_8x4_nn_align1", 2100,
           100),
        _x("kernel", "(anonymous namespace)::flash_bwd_dkv_kernel()", 2300,
           100),
        _x("kernel", "void at::native::vectorized_elementwise_kernel<4>",
           2500, 50),
        _x("kernel", "void at::native::reduce_kernel<512, 1>", 2600, 50),
        _x("kernel", "void at::native::(anonymous namespace)::"
           "multi_tensor_apply_kernel<>", 2700, 40),
        _x("kernel", "some_unknown_kernel", 2800, 10),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2900, 20),
    ]


def test_summarize_reads_window_idle_share_and_categories():
    s = pt.summarize(_trace(), 2)
    assert s["wall_ms_per_step"] == pytest.approx(1.0)
    # busy: 1100-1500 (two overlapping kernels) + 100+100+50+50+40+10+20
    assert s["idle_share"] == pytest.approx(1 - (400 + 370) / 2000)
    assert s["kernel_ms_per_step"] == pytest.approx(
        (200 + 300 + 370) / 2 * 1e-3)
    assert s["launches_per_step"] == 4.0
    want = {"attention fwd (K1/K4)": 200, "gemm": 300,
            "gemm fp32 (no tensor cores)": 100, "attention bwd dk/dv": 100,
            "elementwise": 50, "reduce": 50, "optimizer (foreach)": 40,
            "other": 10, "memcpy": 20}
    got = s["ms_per_step_by_category"]
    assert set(got) == set(want)
    for key, us in want.items():
        assert got[key] == pytest.approx(us / 2 * 1e-3), key


def test_summarize_refuses_a_trace_without_the_step_spans():
    with pytest.raises(ValueError, match="found 2 train_step spans"):
        pt.summarize(_trace(), 3)


def test_profile_train_refuses_the_cpu():
    from youku_mplug_tpu_torch.cli import run_pretrain

    args = run_pretrain.base_parser().parse_args([
        "--config", "configs/pretrain/pretrain_tiny_no_dropout.yaml",
        "--synthetic_data", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="needs --device cuda"):
        pt.main(args)


def test_profile_train_takes_the_instruct_step_and_refuses_the_cpu():
    args = pt.parser().parse_args([
        "--config", "configs/instruct/train_bloomz_7b_flagship.yaml",
        "--instruct", "--synthetic_data", "--device", "cpu"])
    assert args.instruct
    with pytest.raises(RuntimeError, match="needs --device cuda"):
        pt.main(args)


def test_span_device_ms_takes_the_kernels_launched_inside_the_spans():
    """--mplug's BERT attention share: the kernels whose launch (by
    correlation id) falls inside a bert_attention span, per step; a
    kernel launched outside, running while a span is open, is not."""
    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 5, "args": {"correlation": corr}}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": "sgemm", "ts": ts,
                "dur": dur, "args": {"correlation": corr}}
    events = [_x("user_annotation", "bert_attention", 100, 50),
              _x("user_annotation", "bert_attention", 400, 50),
              launch(110, 1), launch(120, 2), launch(300, 3),
              launch(410, 4), kernel(130, 40, 1), kernel(200, 60, 2),
              kernel(310, 500, 3), kernel(420, 100, 4)]
    assert pt.span_device_ms(events, "bert_attention", 2) == \
        pytest.approx((40 + 60 + 100) / 2 * 1e-3)
    args = pt.parser().parse_args([
        "--config", "configs/mplug/mplug_vitb16_zh.yaml", "--mplug",
        "--synthetic_data", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="needs --device cuda"):
        pt.main(args)
