"""Fixtures of the benchmark's CPU tests: a checkout-like root holding a
BENCHMARK.json whose cells run a tiny configuration (the harness reads it
as it reads the real one), and the `cuda` marker for card-only tests."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "name": "tiny-t2a",
    "warm_up_steps": 0,
    "model": {
        "dit": {"in_channels": 4, "context_dim": 32, "hidden_size": 32, "depth": 2, "num_heads": 2,
                "multiple_of": 32, "norm_eps": 1e-5},
        "vae": {"in_channels": 80, "out_ch": 80, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                "attn_layers": [], "down_layers": [0], "kernel_size": 5, "z_channels": 4,
                "double_z": True, "embed_dim": 4},
        "latent_channels": 4, "timesteps": 1000, "scale_factor": 1.0, "scale_by_std": True,
        "cond_stage_trainable": True, "base_learning_rate": 3.0e-6, "cond_kind": "clap_flan"},
    "conditioner": {
        "bert": {"vocab_size": 30522, "hidden_size": 16, "num_layers": 1, "num_heads": 2,
                 "intermediate_size": 32, "max_position": 80, "type_vocab_size": 2,
                 "layer_norm_eps": 1e-12},
        "t5": {"vocab_size": 32128, "d_model": 32, "d_kv": 8, "d_ff": 32, "num_layers": 1,
               "num_heads": 2, "relative_attention_num_buckets": 32,
               "relative_attention_max_distance": 128, "layer_norm_eps": 1e-6},
        "d_proj": 32},
    "vocoder": {"num_mels": 80, "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
                "upsample_initial_channel": 64, "resblock_kernel_sizes": [3, 5],
                "resblock_dilation_sizes": [[1, 3], [1, 3]], "activation": "snakebeta",
                "snake_logscale": True, "resblock": "1", "sampling_rate": 16000},
    "train": {"grad_clip": 1.0},
}
SERVE = {"latent_len": 8, "steps": 3, "scale": 5.0,
         "server": {"max_batch": 4, "batch_window_ms": 30, "max_latent_len": 8},
         "warm_steps": 2, "captions": "captions.txt", "check_requests": 3, "reference_block": 2,
         "profile_after": 0.0, "profile_batches": 1}
CELLS = {
    "tiny-t2a.poisson": ("serve", dict(loop="open", rate_rps=4.0, schedule_seed=1,
                                       warm_buckets=[1, 2, 4], **SERVE),
                         {"wav_gap": 0.05, "missing": 0}),
    "tiny-t2a.closed": ("serve", dict(loop="closed", clients=4, tail_s=1.0, cluster_gap_s=0.05,
                                      warm_buckets=[4], **SERVE), {"wav_gap": 0.05, "missing": 0}),
    "tiny-t2a.train": ("train", {"batch": 4, "spec_crop_len": 16, "files": 8, "drop": 0.2,
                                 "loader_workers": 1, "setup_steps": 3, "captions": "captions.txt",
                                 "rows_per_block": 2, "profile_at": 1, "profile_steps": 1},
                       {"loss_gap": 5e-4, "grad_gap": 0.03, "change_gap": 0.02}),
}


def write_root(root: Path, cells=CELLS) -> Path:
    (root / "benchmark" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "benchmark" / "workloads").mkdir(parents=True, exist_ok=True)
    (root / "benchmark" / "configs" / "tiny-t2a.json").write_text(json.dumps(TINY))
    workloads = []
    for name, (driver, params, limits) in cells.items():
        traffic = name.split(".", 1)[1]
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "tiny-t2a", "traffic": traffic, "driver": driver, "params": params,
             "limits": limits}))
        workloads.append({"name": name, "config": "tiny-t2a", "traffic": traffic, "chips": 1,
                          "why": "a tiny stand-in for the CPU tests"})
    bench = {
        "command": ["python3", "benchmark/run.py"], "paths": ["benchmark"], "run_seconds": 2,
        "configs": [{"name": "tiny-t2a", "source": "tests", "file": "benchmark/configs/tiny-t2a.json",
                     "reduced": [], "why": "tiny"}],
        "workloads": workloads,
        "end_to_end": [
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"},
            {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
             "source": "host_clock", "workloads": ["tiny-t2a.poisson"]},
            {"name": "serve_audio_s_per_s", "unit": "audio_s/s", "better": "higher", "bound": 0.25,
             "source": "host_clock", "workloads": ["tiny-t2a.closed"]},
            {"name": "train_tokens_per_s", "unit": "tokens/s", "better": "higher", "bound": 0.25,
             "source": "host_clock", "workloads": ["tiny-t2a.train"]}],
        "per_layer": [
            {"name": "batch_rows.lat", "unit": "rows", "better": "higher", "source": "program_counter",
             "layer": "server", "moves": "serve_p95_ms", "workloads": ["tiny-t2a.poisson"]},
            {"name": "serve_mfu.tput", "unit": "%", "better": "higher", "source": "device_trace",
             "layer": "whole step", "moves": "serve_audio_s_per_s", "workloads": ["tiny-t2a.closed"]},
            {"name": "loader_wait_ms", "unit": "ms", "better": "lower", "source": "program_span",
             "layer": "data", "moves": "train_tokens_per_s", "workloads": ["tiny-t2a.train"]}],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(tmp_path / "checkout")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped elsewhere")


@pytest.fixture
def tiny_cfg():
    return json.loads(json.dumps(TINY))
