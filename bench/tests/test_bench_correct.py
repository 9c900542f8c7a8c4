"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (the Mixtral configuration's file and limits, its
widths cut to what a test run holds): a sound run passes; a run with the
timed path broken underneath, and the control (the reference in fp8 in
the program's place), come out not correct. The harness's look for a
card is skipped: the run is driven on the CPU."""
import itertools
import time

import pytest
import torch

from bench import correct, harness

CELL = "mixtral.decode.backlog"
SMALL = dict(n_layers=8, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=512, vocab_size=2048, n_experts=8, top_k=2,
             dtype="bfloat16")
SPEC = {"count": 96,
        "prompt": {"median": 24, "sigma": 0.8, "min": 8, "max": 64},
        "output": {"median": 48, "sigma": 0.3, "min": 40, "max": 64},
        "serve": {"slots": 8, "max_len": 256, "page_size": 8,
                  "prefill_chunk": 16, "warm_buckets": [8],
                  "warm_prompt": 9}}


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    # a small run serves fewer tokens than a run on the card compares
    monkeypatch.setattr(harness, "MIN_TOKENS", 100)
    # the harness's clock advances 2 ms a reading, so a window holds the
    # same rounds however busy the CPU is
    ticks = itertools.count()
    monkeypatch.setattr(harness, "clock", lambda: 0.002 * next(ticks))


def _run(seed, **kw):
    torch.set_num_threads(2)
    return harness.run(CELL, seed, 1.0, False, time.perf_counter(),
                       device="cpu", override=SMALL, spec_override=SPEC,
                       **kw)


def test_a_sound_run_is_correct_and_the_control_is_not():
    out = _run(1, control=True)
    assert out["correct"], out["checks"]
    assert out["gaps"]["tokens"] >= 100
    # the control, in the program's place, fails the configured limit
    ctl = correct.checks(out["control"]["fp8"],
                         harness.load_config("mixtral-8x7b.d8")["correct"],
                         100)
    assert not correct.passed(ctl), ctl


def _alter_tokens(system):
    """A token altered where it is produced: row 0 of every step."""
    tr = system.backend.cluster.transport
    orig = tr.decode_step

    def step(*a, **k):
        tok, kk, vv = orig(*a, **k)
        tok = tok.copy()
        tok[0] = (tok[0] + 1) % SMALL["vocab_size"]
        return tok, kk, vv

    tr.decode_step = step


def test_a_token_altered_where_it_is_produced_fails():
    assert not _run(4, fault=_alter_tokens)["correct"]


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    """The decode step's KV write lost: the cache stays as it was."""
    import repro_torch.models.layers as ll
    orig = ll.decode_attention_update_slots_paged

    def unwritten(q, k, v, kp, vp, *a, **kw):
        return orig(q, k, v, kp.clone(), vp.clone(), *a, **kw)[0], kp, vp

    monkeypatch.setattr(ll, "decode_attention_update_slots_paged", unwritten)
    assert not _run(4)["correct"]


def test_the_lora_servers_deltas_left_out_fails(monkeypatch):
    import repro_torch.transport.fused as fused

    def zero(self, hook, layer, rows, *a):
        b = self.pools["up_B" if hook == "up" else "down_B"]
        return torch.zeros(rows.shape[0], b.shape[-1], dtype=torch.float32)

    monkeypatch.setattr(fused.DeviceLoraView, "compute", zero)
    assert not _run(4)["correct"]


@pytest.mark.parametrize("k", [1, 3])
def test_the_sample_holds_the_longest_request(k):
    fin = [{"idx": i, "tokens": [0] * n} for i, n in
           enumerate([5, 9, 9, 2, 7])]
    got = correct.pick_sample(fin, seed=2**40, k=k)
    assert got[0]["idx"] == 1 and len(got) == k
    assert got == correct.pick_sample(fin, seed=2**40, k=k)
