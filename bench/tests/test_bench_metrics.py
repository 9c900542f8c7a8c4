"""The metric readers on synthetic stamps, and the result line's shape."""
import io
import json
import math
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from bench import flops, harness
from bench.metrics import (decode_step_ms, mfu, output_tokens_per_s,
                           round_rest_ms, rows_per_step)

SIZES = {"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "n_layers": 2, "n_experts": 4, "top_k": 2, "d_ff": 32,
         "vocab_size": 512}


def _run(arrivals="backlog", seconds=10.0):
    cell = {"name": "x", "config": "c", "traffic": "t", "chips": 1}
    spec = {"arrivals": arrivals}
    run = harness.Run(cell, spec, seconds)
    run.t_open, run.t_close = 100.0, 100.0 + seconds
    run.sizes, run.ranks = dict(SIZES, lora_scale=1.0), [8, 8]
    return run


def _req(due, stamps, prompt_len=10, adapter=0, prefill=None):
    return {"idx": 0, "adapter": adapter, "prompt": np.zeros(prompt_len),
            "output_len": len(stamps), "due_abs": due, "submitted": due,
            "prefill": stamps[0] if prefill is None and stamps else prefill,
            "stamps": list(stamps), "tokens": [0] * len(stamps),
            "finished": stamps[-1] if stamps else None, "rejected": False}


def test_window_rate_rows_and_round_times():
    run = _run("backlog", seconds=2.0)
    run.rounds = [{"t0": 100.0 + 0.5 * i, "t1": 100.5 + 0.5 * i,
                   "tokens": 64, "decode_ms": 400.0, "admitted": []}
                  for i in range(4)]
    assert output_tokens_per_s.read(run) == pytest.approx(4 * 64 / 2.0)
    assert rows_per_step.read(run) == pytest.approx(64.0)
    assert decode_step_ms.read(run) == pytest.approx(400.0)
    assert round_rest_ms.read(run) == pytest.approx(100.0)
    run.untimed_s = 1.0       # profiler start and stop, left out
    assert output_tokens_per_s.read(run) == pytest.approx(4 * 64 / 1.0)


def test_mfu_counts_the_windows_work_against_the_peak():
    run = _run("backlog", seconds=1.0)
    run.reqs[7] = _req(-1.0, [99.0, 100.2, 100.4], prompt_len=10)
    run.rounds = [{"t0": 100.0, "t1": 100.2, "tokens": 1,
                   "decode_ms": 1.0, "admitted": [7]}]
    m = run.sizes
    want = flops.prefill_flops(m, 9) + flops.decode_flops(m, 10, 8) \
        + flops.decode_flops(m, 11, 8)
    assert mfu.read(run) == pytest.approx(
        100.0 * want / (flops.PEAK_FLOPS * 1.0))


def test_flops_follow_the_formula():
    m = SIZES
    attn = 64 * 64 + 2 * 64 * 32 + 64 * 64
    per_layer = attn + 64 * 4 + 2 * 3 * 64 * 32
    lora = 2 * 8 * (3 * 64 + 3 * 32)
    want = 2 * (2 * per_layer + 2 * lora + 64 * 512) + 4 * 64 * 2 * 6
    assert flops.decode_flops(m, 5, 8) == pytest.approx(want)
    # a prompt of 3 tokens: no lm head, the last layer's experts skipped
    pre = 2 * 3 * (2 * (attn + 64 * 4) + 2 * 3 * 64 * 32) \
        + 4 * 64 * 2 * (1 + 2 + 3)
    assert flops.prefill_flops(m, 3) == pytest.approx(pre)


def test_the_result_line_has_the_contracts_keys_in_order(monkeypatch):
    import torch

    from bench import run as runner
    run = _run("backlog")
    run.setup_s = 12.5
    fake = {"run": run, "correct": True, "attempted": 64, "failed": 0,
            "metrics": {"setup_s": {"value": 12.5, "unit": "s"}},
            "checks": {"served_logit_mean_gap": {"value": 0.01,
                                                 "limit": 0.25}},
            "memory_peak_bytes": 123, "gaps": {"median_gap": 0.0},
            "sample": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(harness, "run", lambda *a, **k: fake)
    # this test process may hold JAX; a run's own process is checked
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = runner.main(["--workload", "qwen3moe.decode.backlog",
                          "--seed", str(2**33), "--seconds", "10",
                          "--trace", "0"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["device"] == {"platform": "gpu", "kind": "card", "count": 1,
                              "memory_peak_bytes": 123}
    assert err.getvalue().strip().splitlines()[-1] == \
        "check served_logit_mean_gap: 0.01 (limit 0.25)"
    # a run whose process loaded the JAX stack prints no result
    monkeypatch.setattr(harness, "forbidden_modules", lambda: ["jax"])
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = runner.main(["--workload", "qwen3moe.decode.backlog",
                          "--seed", "3", "--seconds", "10"])
    assert rc != 0 and out.getvalue() == "" and "jax" in err.getvalue()


def test_no_card_no_result(monkeypatch):
    import torch

    from bench import run as runner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = runner.main(["--workload", "mixtral.decode.backlog", "--seed",
                          "1", "--seconds", "10"])
    assert rc != 0 and out.getvalue() == ""
    assert "CUDA" in err.getvalue()


def test_a_metric_is_read_only_in_cells_of_its_regime():
    """``<base>.<arrivals>`` is read only where the traffic has those
    arrivals; a name without a suffix, everywhere."""
    bench = {"end_to_end": [], "per_layer": [
        {"name": "rows_per_step.backlog", "unit": "rows"},
        {"name": "rows_per_step.steady", "unit": "rows"},
        {"name": "decode_step_ms", "unit": "ms"}]}
    run = _run("steady")
    run.rounds = [{"t0": 100.0, "t1": 100.5, "tokens": 8,
                   "decode_ms": 300.0, "admitted": []}]
    got = harness.read_metrics(bench, "x", run, True)
    assert got == {"rows_per_step.steady": {"value": 8.0, "unit": "rows"},
                   "decode_step_ms": {"value": 300.0, "unit": "ms"}}


def test_the_serve_block_sets_the_systems_config():
    serve = {"slots": 8, "max_len": 256, "page_size": 8, "prefill_chunk": 16,
             "warm_buckets": [8], "warm_prompt": 9}
    cfg = harness.serve_config(serve, 32, False)
    assert (cfg.max_batch, cfg.max_len, cfg.page_size, cfg.prefill_chunk,
            cfg.adapter_cache_slots, cfg.mesh_shape) == \
        (8, 256, 8, 16, 32, None)
    assert (cfg.backend, cfg.disaggregated, cfg.paged, cfg.transport) == \
        ("cluster", True, True, "fused")
    cfg = harness.serve_config(dict(serve, adapter_cache_slots=4,
                                    mesh_shape=[4, 1]), 32, True)
    assert cfg.adapter_cache_slots == 4 and cfg.mesh_shape == (4, 1)
    assert cfg.trace
    with pytest.raises(harness.CellError):
        harness.serve_config(dict(serve, no_such_field=1), 32, False)


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = harness.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]).read), m["name"]
    for w in bench["workloads"]:
        assert harness.cell_metrics(bench, w["name"], False)
        assert harness.cell_metrics(bench, w["name"], True)
        assert math.isfinite(len(w["why"]))
