"""The port's adapter store (``repro_torch.store``) against the JAX
reference's (``repro.store``): the tensorfile container byte for byte in
both directions (BF16 included), the host and disk tiers, the CPU staging
path bit for bit against the port's ``pool_tensors_from_adapter`` and the
reference's bytes, the validation contract, rank-aware byte accounting,
the budget's spill and promotion, miss pricing, and the prefetcher.

Inputs are made with numpy from a seed (or by the JAX initialisers) and
bridged to CPU tensors with their bits (``_t``)."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.core import lora_server as jls
from repro import store as jstore
from repro.store.store import _xfer_seconds as j_xfer_seconds
from repro_torch import bridge
from repro_torch.core import lora_server as tls
from repro_torch.core.adapter import AdapterPool
from repro_torch.store import (AdapterStore, DiskTier, HostTier, Prefetcher,
                               host_tensor_bytes, host_tensors_from_pool,
                               load_tensorfile, random_host_tensors,
                               save_tensorfile, server_tensors_from_host,
                               validate_host_tensors)
from repro_torch.store.store import _xfer_seconds


def _t(a) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a CPU tensor of the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array of the same bits (bfloat16 included)."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return t.contiguous().numpy()


@pytest.fixture(scope="module")
def jcfg():
    return dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_targets=("gate", "up", "down"),
                               lora_rank=8)


@pytest.fixture(scope="module")
def pools(jcfg):
    """A uniform and a mixed-rank reference pool, f32 and bf16, with their
    port twins: {(mixed, dtype): (jax pool, port pool)}."""
    out = {}
    for mixed in (False, True):
        for dt in (jnp.float32, jnp.bfloat16):
            key = jax.random.PRNGKey(3)
            if mixed:
                jp = jadapter.init_mixed_rank_pool(jcfg, [2, 8, 4], key,
                                                   dtype=dt)
            else:
                jp = jadapter.init_adapter_pool(jcfg, 3, key, dtype=dt)
            tensors = {t: {k: _t(v) for k, v in d.items()}
                       for t, d in jax.tree_util.tree_map(
                           np.asarray, jp.tensors).items()}
            tp = AdapterPool(bridge.config_from(jcfg), jp.n, jp.rank,
                             jp.scale, tensors, jp.ranks)
            out[(mixed, dt)] = (jp, tp)
    return out


# ------------------------------ tensorfile ------------------------------- #
def _mixed_tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "up.A": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "up.B": rng.standard_normal((2, 4, 3)).astype(np.float16),
        "down.A": (rng.standard_normal((5,)) * 100).astype(
            ml_dtypes.bfloat16),
        "down.B": rng.standard_normal((3, 2)).astype(ml_dtypes.bfloat16),
        "ids": rng.integers(-9, 9, (4,)).astype(np.int32),
    }


def test_tensorfile_same_bytes_as_reference(tmp_path):
    """The port's file of the same tensors is the reference's file, byte
    for byte (header and payload), BF16 included."""
    tensors = _mixed_tensors()
    ref, got = tmp_path / "ref.tensors", tmp_path / "port.tensors"
    n_ref = jstore.save_tensorfile(str(ref), tensors)
    n_got = save_tensorfile(str(got), {k: _t(v) for k, v in tensors.items()})
    assert n_got == n_ref == sum(v.nbytes for v in tensors.values())
    assert got.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_tensorfile_round_trip_across_packages(tmp_path, direction):
    tensors = _mixed_tensors(1)
    path = str(tmp_path / "a.tensors")
    if direction == "ref_to_port":
        jstore.save_tensorfile(path, tensors)
        got = {k: _np(v) for k, v in load_tensorfile(path).items()}
    else:
        save_tensorfile(path, {k: _t(v) for k, v in tensors.items()})
        got = jstore.load_tensorfile(path)
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


def test_tensorfile_round_trip_bitwise(tmp_path):
    tensors = {k: _t(v) for k, v in _mixed_tensors(2).items()}
    path = str(tmp_path / "b.tensors")
    save_tensorfile(path, tensors)
    got = load_tensorfile(path)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(got[k].view(torch.int16) if v.dtype ==
                           torch.bfloat16 else got[k],
                           v.view(torch.int16) if v.dtype == torch.bfloat16
                           else v)


@pytest.mark.parametrize("blob", [b"\x00" * 4,
                                  (64).to_bytes(8, "little") + b"{",
                                  (2).to_bytes(8, "little") + b"\xff\xfe",
                                  (12).to_bytes(8, "little")
                                  + b'{"x": {"dtype": "Q8"'],
                         ids=["short_length", "short_header", "not_utf8",
                              "cut_json"])
def test_tensorfile_rejects_garbage(tmp_path, blob):
    path = tmp_path / "bad.tensors"
    path.write_bytes(blob)
    with pytest.raises(ValueError):
        load_tensorfile(str(path))
    with pytest.raises(ValueError):
        jstore.load_tensorfile(str(path))


def test_tensorfile_rejects_unknown_dtype_tag(tmp_path):
    import json
    hdr = json.dumps({"x": {"dtype": "Q8", "shape": [1],
                            "data_offsets": [0, 1]}}).encode()
    path = tmp_path / "tag.tensors"
    path.write_bytes(len(hdr).to_bytes(8, "little") + hdr + b"\x00")
    with pytest.raises(ValueError, match="unknown dtype"):
        load_tensorfile(str(path))


# ------------------------------- host tier ------------------------------- #
def test_host_tier_lru_spills_to_callback():
    spilled = []
    tier = HostTier(budget_bytes=100,
                    spill=lambda aid, t: spilled.append((aid, t)))
    a = {"x": torch.zeros(10)}              # 40 bytes each
    tier.put(0, 40, tensors=a)
    tier.put(1, 40, tensors=a)
    assert tier.get(0) is not None          # touch 0 -> 1 is now LRU
    tier.put(2, 40, tensors=a)              # over budget: evicts 1
    assert [aid for aid, _ in spilled] == [1]
    assert tier.get(1) is None
    assert tier.used_bytes == 80
    assert tier.demotions == 1
    assert (tier.hits, tier.misses) == (1, 1)


def test_host_tier_keeps_newest_entry_even_over_budget():
    tier = HostTier(budget_bytes=10, spill=lambda aid, t: None)
    tier.put(0, 40, tensors={"x": torch.zeros(10)})
    assert tier.get(0) is not None          # a lone over-budget entry stays


def test_host_tier_lazy_loader_materializes_once():
    calls = []

    def loader():
        calls.append(1)
        return {"x": torch.arange(4, dtype=torch.float32)}

    tier = HostTier()
    tier.put(7, 16, loader=loader)
    assert calls == []                      # admission does not materialize
    t1 = tier.get(7)
    t2 = tier.get(7)
    assert len(calls) == 1 and t1 is t2
    with pytest.raises(ValueError):
        tier.put(8, 16)                     # neither tensors nor a loader


def test_host_tier_spill_materializes_a_lazy_victim():
    spilled = {}
    tier = HostTier(budget_bytes=16,
                    spill=lambda aid, t: spilled.update({aid: t}))
    tier.put(0, 16, loader=lambda: {"x": torch.ones(4)})
    tier.put(1, 16, tensors={"x": torch.zeros(4)})
    assert list(spilled) == [0] and torch.equal(spilled[0]["x"],
                                                torch.ones(4))
    tier.remove(1)                          # no spill on remove
    assert list(spilled) == [0] and tier.used_bytes == 0


# ------------------------------- disk tier ------------------------------- #
def test_disk_tier_round_trip_and_missing(tmp_path):
    tier = DiskTier(root=str(tmp_path))
    t = {"up.A": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    tier.put(3, t)
    assert tier.put(3, t) == 0 and tier.writes == 1   # immutable: once
    got = tier.get(3)
    assert torch.equal(got["up.A"], t["up.A"]) and tier.reads == 1
    with pytest.raises(KeyError):
        tier.get(4)
    tier.remove(3)
    with pytest.raises(KeyError):
        tier.get(3)


def test_disk_tier_owned_tempdir_is_removed_at_close():
    import os
    tier = DiskTier()
    assert 0 not in tier                    # no directory made yet
    tier.put(0, {"x": torch.zeros(2)})
    root = tier.root
    assert os.path.isdir(root)
    tier.close()
    assert not os.path.exists(root)


# --------------------------- staging equivalence ------------------------- #
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_host_staging_matches_pool_extraction_bitwise(jcfg, pools, mixed,
                                                      dtype):
    """The CPU staging path (trim to the true rank, pad, gate/up fusion)
    equals the port's ``pool_tensors_from_adapter`` bit for bit, and both
    hold the reference's bytes (its own staging and its pool
    extraction)."""
    jp, tp = pools[(mixed, dtype)]
    for aid in range(3):
        host = host_tensors_from_pool(tp, aid)
        jhost = jstore.host_tensors_from_pool(jp, aid)
        assert sorted(host) == sorted(jhost)
        for k in host:
            assert _np(host[k]).tobytes() == jhost[k].tobytes(), k
            assert host[k].is_contiguous()
        staged = server_tensors_from_host(tp.cfg, host, tp.rank)
        direct = tls.pool_tensors_from_adapter(tp, aid)
        jstaged = jls.pool_tensors_from_adapter(jp, aid)
        assert sorted(staged) == sorted(direct) == sorted(jstaged)
        for k in direct:
            assert staged[k].dtype == direct[k].dtype, k
            assert staged[k].shape == direct[k].shape, k
            assert _np(staged[k]).tobytes() == \
                _np(direct[k].contiguous()).tobytes() == \
                np.asarray(jstaged[k]).tobytes(), k


def test_host_tensors_are_copies(pools):
    _, tp = pools[(False, jnp.float32)]
    host = host_tensors_from_pool(tp, 0)
    host["up.A"].zero_()
    assert tp.tensors["up"]["A"][:, 0].abs().sum() > 0


def test_validate_host_tensors_rejections(jcfg):
    cfg = bridge.config_from(jcfg)
    good = random_host_tensors(cfg, 4, seed=0)
    assert validate_host_tensors(cfg, good, 8) == 4
    with pytest.raises(ValueError):        # rank above the slot pools
        validate_host_tensors(cfg, good, 2)
    missing = {k: v for k, v in good.items() if k != "up.B"}
    with pytest.raises(ValueError):
        validate_host_tensors(cfg, missing, 8)
    extra = dict(good, **{"qkv.A": next(iter(good.values()))})
    with pytest.raises(ValueError):        # target not in the active set
        validate_host_tensors(cfg, extra, 8)
    bad = dict(good)
    bad["up.A"] = bad["up.A"][..., :-1, :]  # wrong d_in
    with pytest.raises(ValueError, match="A shape"):
        validate_host_tensors(cfg, bad, 8)
    bad = dict(good)
    bad["down.B"] = bad["down.B"][:, 1:]    # wrong expert count
    with pytest.raises(ValueError, match="B shape"):
        validate_host_tensors(cfg, bad, 8)
    bad = dict(good)
    bad["gate.B"] = torch.cat([bad["gate.B"], bad["gate.B"]], dim=-2)
    with pytest.raises(ValueError, match="inconsistent rank"):
        validate_host_tensors(cfg, bad, 8)
    # the reference accepts and refuses the same sets
    jgood = {k: _np(v) for k, v in good.items()}
    assert jstore.validate_host_tensors(jcfg, jgood, 8) == 4
    with pytest.raises(ValueError):
        jstore.validate_host_tensors(jcfg, jgood, 2)


def test_random_host_tensors_seeded_and_shaped(jcfg):
    cfg = bridge.config_from(jcfg)
    a = random_host_tensors(cfg, 4, seed=5)
    b = random_host_tensors(cfg, 4, seed=5)
    c = random_host_tensors(cfg, 4, seed=6)
    want = jstore.random_host_tensors(jcfg, 4, seed=5)
    assert sorted(a) == sorted(want)
    for k in a:
        assert a[k].dtype == torch.bfloat16
        assert tuple(a[k].shape) == want[k].shape
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert validate_host_tensors(cfg, a, 8) == 4


# --------------------------- byte accounting ----------------------------- #
def test_adapter_bytes_is_rank_aware(pools):
    for dt in (jnp.float32, jnp.bfloat16):
        jp, tp = pools[(True, dt)]
        assert tp.bytes_per_adapter() == jp.bytes_per_adapter()
        assert [tp.adapter_bytes(i) for i in range(3)] == \
            [jp.adapter_bytes(i) for i in range(3)]
        per_slot = tp.bytes_per_adapter()
        assert sum(tp.adapter_bytes(i) for i in range(3)) < 3 * per_slot
        assert tp.adapter_bytes(1) == per_slot     # the full-rank adapter
        assert host_tensor_bytes(host_tensors_from_pool(tp, 0)) == \
            tp.adapter_bytes(0)
        _, up = pools[(False, dt)]
        assert up.adapter_bytes(0) == up.bytes_per_adapter()


# ------------------------------ AdapterStore ----------------------------- #
def _stores(jcfg, pools, mixed=False, dtype=jnp.float32, **kw):
    jp, tp = pools[(mixed, dtype)]
    kw.setdefault("prefetch", False)
    return (jstore.AdapterStore(jcfg, jp, **kw),
            AdapterStore(tp.cfg, tp, **kw))


def test_store_budget_spills_to_disk_and_promotes_bitwise(jcfg, pools):
    jp, tp = pools[(True, jnp.bfloat16)]
    b = tp.adapter_bytes(1)
    jst, st = _stores(jcfg, pools, True, jnp.bfloat16, host_bytes=b + 1)
    try:
        assert st.stats() == jst.stats()
        assert st.stats()["disk_writes"] >= 1
        assert sorted(st.host.resident_ids()) == \
            sorted(jst.host.resident_ids())
        for aid in range(3):                # staged from host or disk
            got = st.server_tensors(aid)
            want = jst.server_tensors(aid)
            direct = tls.pool_tensors_from_adapter(tp, aid)
            for k in want:
                assert _np(got[k]).tobytes() == want[k].tobytes() == \
                    _np(direct[k].contiguous()).tobytes(), k
            assert st.stats() == jst.stats()
        assert st.stats()["disk_reads"] >= 1
    finally:
        st.close()
        jst.close()


def test_store_register_unregister_and_alpha_rescale(jcfg, pools):
    jst, st = _stores(jcfg, pools)
    try:
        raw = random_host_tensors(st.cfg, 4, seed=1)
        assert st.register(9, raw, alpha=16.0) == 4
        assert jst.register(9, {k: _np(v) for k, v in raw.items()},
                            alpha=16.0) == 4
        with pytest.raises(ValueError):     # duplicate id
            st.register(9, raw, alpha=16.0)
        got, want = st.host_tensors(9), jst.host_tensors(9)
        for k in want:                      # the reference's bf16 rescale
            assert _np(got[k]).tobytes() == want[k].tobytes(), k
        assert torch.equal(got["up.A"], raw["up.A"])
        assert not torch.equal(got["up.B"], raw["up.B"])
        assert st.adapter_bytes(9) == jst.adapter_bytes(9)
        assert st.rank_of(9) == 4 and st.registered_ids() == [0, 1, 2, 9]
        st.unregister(9)
        assert not st.has(9)
        with pytest.raises(ValueError):
            st.unregister(9)
        with pytest.raises(KeyError):
            st.host_tensors(9)
    finally:
        st.close()
        jst.close()


def test_store_load_seconds_pricing(jcfg, pools):
    """The reference's numbers: free loads at infinite bandwidth, a host
    hit pays the upload, a disk hit the read and the upload."""
    _, tp = pools[(True, jnp.float32)]
    b = max(tp.adapter_bytes(i) for i in range(3))
    jfree, free = _stores(jcfg, pools, True, host_bw=float("inf"))
    try:
        assert free.load_seconds(0) == jfree.load_seconds(0) == 0.0
    finally:
        free.close()
        jfree.close()
    jst, st = _stores(jcfg, pools, True, host_bytes=b, host_bw=1e9,
                      disk_bw=1e8)
    try:
        for aid in range(3):
            assert st.load_seconds(aid) == jst.load_seconds(aid)
        resident = st.host.resident_ids()[-1]
        spilled = [a for a in range(3) if a not in st.host][0]
        assert st.load_seconds(resident) == pytest.approx(
            tp.adapter_bytes(resident) / 1e9)
        assert st.load_seconds(spilled) == pytest.approx(
            tp.adapter_bytes(spilled) / 1e8 + tp.adapter_bytes(spilled) / 1e9)
        assert st.load_seconds(99) == 0.0
        for store in (st, jst):
            store.host_tensors(resident)
            store.host_tensors(spilled)     # disk promote
        assert (st.host_hits, st.disk_hits) == \
            (jst.host_hits, jst.disk_hits) == (1, 1)
        for aid in range(3):                # the promotion moved the prices
            assert st.load_seconds(aid) == jst.load_seconds(aid)
    finally:
        st.close()
        jst.close()


def test_xfer_seconds_handles_degenerate_bandwidth():
    for bw, nb in ((float("inf"), 1000), (0.0, 1000), (2e3, 1000),
                   (None, 5)):
        assert _xfer_seconds(nb, bw) == j_xfer_seconds(nb, bw)
    assert _xfer_seconds(1000, 2e3) == pytest.approx(0.5)


# ------------------------------- prefetcher ------------------------------ #
def test_prefetcher_stages_bitwise_and_dedups(jcfg, pools):
    _, tp = pools[(True, jnp.float32)]
    st = AdapterStore(tp.cfg, tp, prefetch=True)
    try:
        assert st.prefetch(1) is True
        assert st.prefetch(1) is False      # already in flight or staged
        assert st.prefetch(7) is False      # not registered
        assert st.wait_prefetched() == [1]
        assert st.prefetch(1) is False      # staged
        staged = st.server_tensors(1)
        assert st.stats()["staged_hits"] == 1
        assert st.stats()["prefetch_staged"] == 1
        direct = tls.pool_tensors_from_adapter(tp, 1)
        for k in direct:
            assert torch.equal(staged[k], direct[k]), k
    finally:
        st.close()
    off = AdapterStore(tp.cfg, tp, prefetch=False)
    assert off.prefetch(1) is False
    off.close()


def test_upload_takes_the_staging_in_flight(jcfg, pools):
    """An upload of an adapter the worker is still staging waits for that
    result instead of staging it a second time beside it."""
    import threading
    _, tp = pools[(True, jnp.float32)]
    st = AdapterStore(tp.cfg, tp, prefetch=True)
    gate = threading.Event()
    stage = st._prefetcher._stage_fn
    st._prefetcher._stage_fn = lambda aid: (gate.wait(10.0), stage(aid))[1]
    timer = threading.Timer(0.05, gate.set)
    try:
        assert st.prefetch(2) is True
        timer.start()
        got = st.server_tensors(2)
        s = st.stats()
        assert (s["prefetch_staged"], s["staged_hits"], s["sync_stages"]) \
            == (1, 1, 0)
        assert st._staged == {} and not st._prefetcher.in_flight(2)
        direct = tls.pool_tensors_from_adapter(tp, 2)
        for k in direct:
            assert torch.equal(got[k], direct[k]), k
    finally:
        timer.cancel()
        st.close()


def test_prefetcher_relays_worker_exceptions():
    def boom(aid):
        raise RuntimeError(f"stage {aid} failed")

    pf = Prefetcher(boom)
    try:
        assert pf.request(0)
        with pytest.raises(RuntimeError, match="stage 0 failed"):
            pf.wait(timeout=10.0)
        assert pf.request(0)                # the failed job left the set
        with pytest.raises(RuntimeError, match="stage 0 failed"):
            pf.wait(timeout=10.0)
    finally:
        pf.close()


def test_store_prefetch_thread_and_main_thread_stress(jcfg, pools):
    """The prefetch worker and the serving thread share the tiers: under a
    budget of one adapter and a shortened switch interval, interleaved
    prefetches and synchronous stagings keep the host tier's byte count
    and every staged layout exact."""
    import sys
    _, tp = pools[(True, jnp.bfloat16)]
    direct = {a: tls.pool_tensors_from_adapter(tp, a) for a in range(3)}
    st = AdapterStore(tp.cfg, tp, prefetch=True,
                      host_bytes=tp.adapter_bytes(1))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(60):
            st.prefetch(i % 3)
            got = st.server_tensors((i + 1) % 3)
            for k, v in direct[(i + 1) % 3].items():
                assert torch.equal(got[k], v), k
            st.drain_prefetched()
        st.wait_prefetched(timeout=30.0)
        ent = st.host._entries
        assert st.host.used_bytes == sum(e[0] for e in ent.values())
        assert len(ent) == 1
        s = st.stats()
        assert s["prefetch_staged"] == s["prefetch_requests"] > 0
        assert s["host_hits"] + s["disk_hits"] == \
            s["prefetch_staged"] + s["sync_stages"]
    finally:
        sys.setswitchinterval(old)
        st.close()
    assert not (st._prefetcher._thread and st._prefetcher._thread.is_alive())
