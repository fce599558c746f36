"""The serve profiler (youku_mplug_tpu_torch/cli/profile_serve.py) on the
CPU at a tiny size: its JSON line splits each run's host time by engine
phase."""

import json

import torch

from youku_mplug_tpu_torch.cli import profile_serve, serve

torch.set_num_threads(1)


def test_profile_serve_splits_a_run_by_engine_phase(tmp_path, capsys):
    args = serve.serve_parser().parse_args([
        "--config", "configs/pretrain_tiny.yaml", "--synthetic_data",
        "--num_requests", "2", "--device", "cpu", "--output_dir",
        str(tmp_path)])
    summary = profile_serve.main(args)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(summary))
    assert len(summary["runs"]) == profile_serve.REPEATS
    for run in summary["runs"]:
        assert run["requests"] == 2 and run["decode_steps"] > 0
        for phase in ("encode_ms", "admit_ms", "step_ms",
                      "decode_enqueue_ms"):
            assert 0 < run[phase]["median"] <= run[phase]["max"] \
                <= run[phase]["sum"]
        # the engine's steps hold its admissions and decodes
        assert run["step_ms"]["sum"] >= run["admit_ms"]["sum"] \
            + run["decode_enqueue_ms"]["sum"]
