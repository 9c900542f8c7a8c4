"""The benchmark's traffic generator: seeded, the same work for every
seed, and found by the traffic file's name."""
import json
import sys
import types

import numpy as np
import pytest

from bench import workload


def _spec(**kw):
    spec = {"arrivals": "backlog", "count": 40, "strata": 16,
            "zipf_s": 1.2,
            "prompt": {"median": 64, "sigma": 0.9, "min": 8, "max": 256},
            "output": {"median": 32, "sigma": 0.7, "min": 4, "max": 128}}
    spec.update(kw)
    return spec


def _key(reqs):
    return [(r.adapter, r.due, tuple(r.prompt.tolist()), r.output_len)
            for r in reqs]


def test_same_seed_same_traffic():
    a = workload.generate(_spec(), 8, 1000, seed=2**33 + 5, seconds=10)
    b = workload.generate(_spec(), 8, 1000, seed=2**33 + 5, seconds=10)
    assert _key(a) == _key(b)
    c = workload.generate(_spec(), 8, 1000, seed=2**33 + 6, seconds=10)
    assert _key(a) != _key(c)


@pytest.mark.parametrize("arrivals", ["backlog"])
def test_every_seed_gets_the_same_work(arrivals):
    spec = _spec(arrivals=arrivals, count=64)
    runs = [workload.generate(spec, 8, 1000, seed=s, seconds=10)
            for s in (1, 2, 3)]
    for reqs in runs[1:]:
        assert len(reqs) == len(runs[0])
        # the same sizes, block by block, in another order
        for blk in range(0, len(reqs) - 16 + 1, 16):
            got = sorted(len(r.prompt) for r in reqs[blk:blk + 16])
            ref = sorted(len(r.prompt) for r in runs[0][blk:blk + 16])
            assert got == ref
        full = len(reqs) // 16 * 16      # the last block is cut short
        assert sorted(r.output_len for r in reqs[:full]) == \
            sorted(r.output_len for r in runs[0][:full])
        gaps = np.diff([r.due for r in reqs[:full + 1]])
        ref_gaps = np.diff([r.due for r in runs[0][:full + 1]])
        assert np.allclose(sorted(gaps), sorted(ref_gaps))


def test_lengths_and_arrivals_follow_the_spec():
    spec = _spec(count=160)
    reqs = workload.generate(spec, 8, 1000, seed=7, seconds=20)
    assert len(reqs) == 160
    assert all(8 <= len(r.prompt) <= 256 for r in reqs)
    assert all(4 <= r.output_len <= 128 for r in reqs)
    assert all(0 <= r.adapter < 8 for r in reqs)
    # a backlog: every request is due when the window opens
    assert {r.due for r in reqs} == {0.0}
    med = np.median([len(r.prompt) for r in reqs])
    assert 48 <= med <= 80
    assert 24 <= np.median([r.output_len for r in reqs]) <= 40


def test_an_arrival_process_is_found_by_name(monkeypatch):
    """A traffic file names its arrival process; the module of that name
    in ``bench/arrivals/`` gives the count and the due times."""
    steady = types.ModuleType("bench.arrivals.steady")
    steady.count = lambda spec, seconds: int(seconds * spec["rate"])
    steady.due = lambda spec, n, rng, strata: np.arange(n) / spec["rate"]
    monkeypatch.setitem(sys.modules, "bench.arrivals.steady", steady)
    reqs = workload.generate(_spec(arrivals="steady", rate=4.0), 8, 1000,
                             seed=3, seconds=5)
    assert [r.due for r in reqs] == [i / 4.0 for i in range(20)]
    with pytest.raises(ModuleNotFoundError):
        workload.generate(_spec(arrivals="no_such_process"), 8, 1000,
                          seed=3, seconds=5)
    with pytest.raises(ValueError):
        workload.arrivals(_spec(arrivals="../backlog"))


def test_zipf_popularity_by_rank_is_fixed():
    spec = _spec(arrivals="backlog", count=128)
    for seed in (3, 4):
        reqs = workload.generate(spec, 8, 1000, seed=seed, seconds=1)
        counts = sorted(np.bincount([r.adapter for r in reqs],
                                    minlength=8).tolist(), reverse=True)
        share = workload.zipf_popularity(8, 1.2) * 16
        assert counts[0] == 8 * round(share[0]) or counts[0] >= counts[1]
        assert counts == sorted(counts, reverse=True)
    a = workload.adapter_ranks(8, [8, 16, 32, 32], seed=3)
    b = workload.adapter_ranks(8, [8, 16, 32, 32], seed=4)
    assert sorted(a) == sorted(b) == [8, 8, 16, 16, 32, 32, 32, 32]
    # the most popular adapter has the cycle's first rank, whatever the seed
    for seed, ranks in ((3, a), (4, b)):
        reqs = workload.generate(spec, 8, 1000, seed=seed, seconds=1)
        top = np.bincount([r.adapter for r in reqs], minlength=8).argmax()
        assert ranks[top] == 8


def test_warmup_wave_passes_through_each_bucket():
    wave = workload.warmup_wave([1, 2, 4, 8, 16, 32, 64], 32, 1000, 9, 5)
    assert len(wave) == 64
    assert {r.adapter for r in wave} == set(range(32))
    alive = [sum(1 for r in wave if r.output_len >= s) for s in range(1, 9)]
    buckets = [1 << (n - 1).bit_length() for n in alive]
    assert sorted(set(buckets)) == [1, 2, 4, 8, 16, 32, 64]
    only = workload.warmup_wave([64], 32, 1000, 9, 5)
    assert {1 << (sum(1 for r in only if r.output_len >= s) - 1).bit_length()
            for s in (1, 2)} == {64}


def test_a_traffic_file_is_found_by_name(tmp_path, monkeypatch):
    spec = _spec(arrivals="backlog", count=4)
    (tmp_path / "tiny-mix.json").write_text(json.dumps(spec))
    monkeypatch.setattr(workload, "TRAFFIC_DIR", tmp_path)
    got = workload.load_traffic("tiny-mix")
    assert got["count"] == 4 and got["name"] == "tiny-mix"
    with pytest.raises(FileNotFoundError):
        workload.load_traffic("no-such-mix")


def test_the_shipped_traffic_files_load():
    for name in sorted(p.stem for p in workload.TRAFFIC_DIR.glob("*.json")):
        spec = workload.load_traffic(name)
        reqs = workload.generate(spec, 32, 151936, seed=1, seconds=10)
        assert reqs and all(len(r.prompt) + r.output_len
                            <= spec["serve"]["max_len"] + 1 for r in reqs)
