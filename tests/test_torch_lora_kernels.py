"""Parity of the port's LoRA-kernel path with the JAX reference: the plain
twins of ``bgmv_ranked``, ``sgmv``, ``sgmv_ranked``, ``fused_sgmv``,
``fused_sgmv_ranked`` and ``gmm``, the segment layout helpers, the
rank-bucketed dispatch, and the path's entry point
(``repro_torch.launch.kernels``).

Inputs come from numpy seeds. Each twin is held against the reference's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and its
jnp oracle within 1e-6 abs in f32: the reference's own Pallas kernels and
oracles differ by up to 1.5e-7, so no bits are demanded across the two
frameworks. Inside the port, ranked and padded forms agree bit for bit on a
prefix-zero pool, and the layout helpers equal the reference's exactly.
The CUDA kernels run only on the card: the tests marked ``gpu`` hold them
against the twins there and skip here.
"""
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import bgmv as tbgmv
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sgmv as tsgmv
from repro_torch.launch import kernels as tlaunch

TOL = 1e-6
ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = np.array([2, 8, 4, 8], np.int32)     # true ranks in a rank-8 pool
N, D_IN, R, D_OUT = 4, 24, 8, 40


def _pool(rng, lead, prefix_zero: bool):
    """A (lead..., D_IN, R), B (lead..., R, D_OUT); with prefix_zero the
    columns past each adapter's true rank (RANKS over the first axis) hold
    +0.0 exactly."""
    A = (rng.standard_normal(lead + (D_IN, R)) / R).astype(np.float32)
    B = (rng.standard_normal(lead + (R, D_OUT)) * 0.1).astype(np.float32)
    if prefix_zero:
        for n, rank in enumerate(RANKS[: lead[0]]):
            A[n, ..., rank:] = 0.0
            B[n, ..., rank:, :] = 0.0
    return A, B


def _inputs(name: str, prefix_zero: bool = True, seed: int = 3):
    """Numpy arguments of one op, in its (reference and port) order."""
    rng = np.random.default_rng(seed)
    if name in ("bgmv", "bgmv_ranked"):
        A, B = _pool(rng, (N,), prefix_zero)
        x = rng.standard_normal((9, D_IN)).astype(np.float32)
        ids = np.array([0, -1, 3, 1, 2, -1, 3, 0, 2], np.int32)
        return ((x, A, B, ids, RANKS) if name == "bgmv_ranked"
                else (x, A, B, ids))
    if name.startswith("sgmv"):
        A, B = _pool(rng, (N,), prefix_zero)
        seg = rng.standard_normal((5, 4, D_IN)).astype(np.float32)
        seg[1, 2:] = 0.0                         # a segment's padding rows
        ad = np.array([0, 2, -1, 3, 1], np.int32)
        rank = np.where(ad >= 0, RANKS[np.maximum(ad, 0)], 0).astype(np.int32)
        return ((seg, ad, A, B) if name == "sgmv"
                else (seg, ad, rank, A, B))
    if name.startswith("fused_sgmv"):
        A, B = _pool(rng, (3, 4), prefix_zero)   # 3 slots x 4 experts
        seg = rng.standard_normal((6, 4, D_IN)).astype(np.float32)
        slot = np.array([0, 2, -1, 1, 2, 0], np.int32)
        eid = np.array([1, 0, 3, 3, 2, 1], np.int32)
        rank = np.where(slot >= 0, RANKS[np.maximum(slot, 0)], 0
                        ).astype(np.int32)
        return ((seg, slot, eid, A, B) if name == "fused_sgmv"
                else (seg, slot, eid, rank, A, B))
    assert name == "gmm"
    xe = rng.standard_normal((4, 6, D_IN)).astype(np.float32)
    w = (rng.standard_normal((4, D_IN, D_OUT)) * 0.2).astype(np.float32)
    return xe, w, np.array([0, 3, 6, 1], np.int32)


def _t(args, device="cpu", dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(device) if a.dtype == np.int32
                 else torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in args)


TWINS = ["bgmv_ranked", "sgmv", "sgmv_ranked", "fused_sgmv",
         "fused_sgmv_ranked", "gmm", "sgmv_rank_grouped"]


# ------------------------------ the twins ------------------------------ #
# sgmv_rank_grouped is held against the reference through its own layout
# below: the reference's bucketed dispatch needs cap to be a multiple of 8
@pytest.mark.parametrize("name", TWINS[:-1])
def test_twin_matches_pallas_and_oracle(monkeypatch, name):
    args = _inputs(name)
    got = getattr(tref, f"{name}_ref")(*_t(args)).numpy()
    oracle = np.asarray(getattr(jref, f"{name}_ref")(
        *[jnp.asarray(a) for a in args]))
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    pallas = np.asarray(getattr(jops, name)(*[jnp.asarray(a) for a in args]))
    assert got.dtype == np.float32 and got.shape == oracle.shape
    np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["bgmv_ranked", "sgmv", "fused_sgmv"])
def test_inactive_rows_and_segments_are_exact_zeros(name):
    args = _inputs(name)
    got = getattr(tref, f"{name}_ref")(*_t(args))
    if name == "bgmv_ranked":
        assert torch.all(got[torch.from_numpy(args[3]) < 0] == 0)
    else:
        assert torch.all(got[torch.from_numpy(args[1]) < 0] == 0)


def test_gmm_ref_zeroes_rows_past_group_sizes():
    xe, w, gs = _t(_inputs("gmm"))
    got = tref.gmm_ref(xe, w, gs)
    for e in range(4):
        assert torch.all(got[e, int(gs[e]):] == 0)
    torch.testing.assert_close(tref.gmm_ref(xe, w)[1, :3], got[1, :3],
                               rtol=0, atol=0)


@pytest.mark.parametrize("ranked,padded", [
    ("bgmv_ranked", "bgmv"), ("sgmv_ranked", "sgmv"),
    ("fused_sgmv_ranked", "fused_sgmv")])
def test_ranked_equals_padded_bitwise_on_prefix_zero_pool(ranked, padded):
    args = _t(_inputs(ranked))
    got = getattr(tref, f"{ranked}_ref")(*args)
    if ranked == "bgmv_ranked":
        want = tref.bgmv_ref(*args[:4])
    else:  # drop the rank operand
        want = getattr(tref, f"{padded}_ref")(*args[:-3], *args[-2:])
    assert torch.equal(got, want)
    # without the prefix-zero contract the mask is not a no-op
    loose = _t(_inputs(ranked, prefix_zero=False))
    assert not torch.equal(getattr(tref, f"{ranked}_ref")(*loose),
                           getattr(tref, f"{padded}_ref")(
                               *(loose[:4] if ranked == "bgmv_ranked"
                                 else loose[:-3] + loose[-2:])))


def test_bgmv_ranked_ref_clamps_ids_past_the_pool():
    x, A, B, ids, ranks = _t(_inputs("bgmv_ranked"))
    big = ids.clone()
    big[0] = N + 5
    want = ids.clone()
    want[0] = N - 1
    assert torch.equal(tref.bgmv_ranked_ref(x, A, B, big, ranks),
                       tref.bgmv_ranked_ref(x, A, B, want, ranks))


# --------------------------- segment layout ---------------------------- #
def _row_batches():
    rng = np.random.default_rng(7)
    return {
        "random_with_padding": rng.integers(-1, 7, 41).astype(np.int32),
        "padding_then_full_adapter0": np.array(
            [-1, -1, -1, 0, 0, 0, 0, 1, 2, 2], np.int32),
        "overflow_dropped": np.array([1] * 7 + [0, 2, -1, 1], np.int32),
        "all_padding": np.full(4, -1, np.int32),
    }


BATCHES = _row_batches()


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_build_segments_equal_reference(batch):
    ids = BATCHES[batch]
    n_adapters = 7 if batch == "random_with_padding" else 3
    cap = 4
    rows = np.random.default_rng(1).standard_normal((ids.size, 8)
                                                    ).astype(np.float32)
    want = jops.build_segments(jnp.asarray(rows), jnp.asarray(ids),
                               n_adapters, cap)
    got = tops.build_segments(torch.from_numpy(rows), torch.from_numpy(ids),
                              n_adapters, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == got[2].dtype == torch.int32
    ranks = np.array([8, 4, 16, 4, 32, 8, 4], np.int32)[:n_adapters]
    want = jops.build_segments_ranked(jnp.asarray(rows), jnp.asarray(ids),
                                      n_adapters, cap, ranks)
    got = tops.build_segments_ranked(torch.from_numpy(rows),
                                     torch.from_numpy(ids), n_adapters, cap,
                                     ranks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(t.dtype == torch.int32 for t in got[1:])


def test_gather_rows_recovers_each_rows_result():
    ids = torch.from_numpy(BATCHES["overflow_dropped"])
    rows = torch.randn(ids.shape[0], 8, generator=torch.Generator()
                       .manual_seed(0))
    seg, _, scatter = tops.build_segments(rows, ids, 3, 4)
    back = tsgmv.gather_rows(seg, scatter)
    kept = scatter < 12
    assert torch.equal(back[kept], rows[kept])
    assert torch.all(back[~kept] == 0)
    assert int((~kept).sum()) == 5     # one padding row, 4 past cap


# ----------------------------- rank buckets ---------------------------- #
def test_sgmv_rank_grouped_matches_reference(monkeypatch):
    """Through build_segments_ranked, as the reference's own test runs it."""
    rng = np.random.default_rng(9)
    ranks = np.array([8, 4, 16, 4, 32, 8, 4], np.int32)
    A = (rng.standard_normal((7, 16, 32)) * 0.05).astype(np.float32)
    B = (rng.standard_normal((7, 32, 24)) * 0.05).astype(np.float32)
    for n, rank in enumerate(ranks):
        A[n, :, rank:] = 0.0
        B[n, rank:, :] = 0.0
    rows = rng.standard_normal((41, 16)).astype(np.float32)
    ids = rng.integers(-1, 7, 41).astype(np.int32)
    seg = tops.build_segments_ranked(torch.from_numpy(rows),
                                     torch.from_numpy(ids), 7, 8, ranks)
    got = tops.sgmv_rank_grouped(*seg[:3], *_t((A, B)))
    jseg = jops.build_segments_ranked(jnp.asarray(rows), jnp.asarray(ids),
                                      7, 8, ranks)
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    want = np.asarray(jops.sgmv_rank_grouped(*jseg[:3], jnp.asarray(A),
                                             jnp.asarray(B)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert torch.equal(got, tref.sgmv_ranked_ref(*seg[:3], *_t((A, B))))


def _bucket_plan(ad, rank, r):
    idle, buckets = tsgmv.rank_buckets(ad, rank, r)
    assert all(i.dtype == torch.int32 for _, i in buckets)
    return idle.tolist(), [(cols, i.tolist()) for cols, i in buckets]


def test_rank_buckets_plan():
    ad = torch.tensor([3, 0, 5, 1, 2, -1, -1], dtype=torch.int32)
    rank = torch.tensor([2, 4, 4, 16, 64, 0, 0], dtype=torch.int32)
    assert _bucket_plan(ad, rank, 64) == (
        [5, 6], [(2, [0]), (4, [1, 2]), (16, [3]), (64, [4])])
    # a bucket's columns are its rank, at most the pool rank: no rounding
    assert _bucket_plan(ad, rank, 32)[1][-1] == (32, [4])
    assert _bucket_plan(ad[5:], rank[5:], 64) == ([0, 1], [])
    # the segments of one rank need not be contiguous: any order is taken
    assert _bucket_plan(torch.tensor([0, 1, 2], dtype=torch.int32),
                        torch.tensor([4, 8, 4], dtype=torch.int32), 64) == (
        [], [(4, [0, 2]), (8, [1])])


def _rank_grouped_by_plan(seg, ad, rank, A, B):
    """sgmv_rank_grouped's launches as csrc/sgmv.cu runs them (each bucket
    through the padded twin over its index list and first rank columns;
    the inactive segments zeros), on the CPU."""
    out = torch.full((seg.shape[0], seg.shape[1], B.shape[-1]), float("nan"))
    idle, buckets = tsgmv.rank_buckets(ad, rank, A.shape[-1])
    out[idle.long()] = 0.0
    for cols, idx in buckets:
        i = idx.long()
        out[i] = tref.sgmv_ref(seg[i], ad[i], A[..., :cols], B[:, :cols])
    return out


def test_sgmv_rank_grouped_takes_any_bucket_order(monkeypatch):
    """build_segments' layout (adapter order, ranks interleaved) against
    the reference's Pallas dispatch, which gathers each bucket by index."""
    rng = np.random.default_rng(11)
    ranks = np.array([8, 4, 16, 4, 32, 8, 4], np.int32)
    A = (rng.standard_normal((7, 16, 32)) * 0.05).astype(np.float32)
    B = (rng.standard_normal((7, 32, 24)) * 0.05).astype(np.float32)
    for n, rank in enumerate(ranks):
        A[n, :, rank:] = 0.0
        B[n, rank:, :] = 0.0
    rows = rng.standard_normal((41, 16)).astype(np.float32)
    ids = rng.integers(-1, 7, 41).astype(np.int32)
    seg, ad, _ = tops.build_segments(torch.from_numpy(rows),
                                     torch.from_numpy(ids), 7, 8)
    rank = torch.where(ad >= 0, torch.from_numpy(ranks)[ad.long().clamp(
        min=0)], 0).to(torch.int32)
    act = rank[ad >= 0].tolist()
    assert act != sorted(act)            # the buckets are interleaved
    got = tops.sgmv_rank_grouped(seg, ad, rank, *_t((A, B)))
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    want = np.asarray(jops.sgmv_rank_grouped(
        jnp.asarray(seg.numpy()), jnp.asarray(ad.numpy()),
        jnp.asarray(rank.numpy()), jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        _rank_grouped_by_plan(seg, ad, rank, *_t((A, B))).numpy(), want,
        rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype,vec,cols", [(torch.bfloat16, 8, 24),
                                            (torch.float32, 4, 20)])
def test_sgmv_takes_rank_groups_that_do_not_divide_the_threads(dtype, vec,
                                                                cols):
    # a bucket of rank cols - 1 (23 bf16 or 19 f32 columns, not a whole
    # number of the 16-byte vector) reads exactly its rank's columns
    ad = torch.tensor([0, 1], dtype=torch.int32)
    rank = torch.tensor([4, cols - 1], dtype=torch.int32)
    assert (cols - 1) % vec
    assert _bucket_plan(ad, rank, 24)[1] == [(4, [0]), (cols - 1, [1])]
    A = torch.zeros((2, 16, 24), dtype=dtype)
    B = torch.zeros((2, 24, 41), dtype=dtype)
    # sgmv.cu, bgmv.cu and bgmv_expert.cu take any rank and any d_out
    tbgmv._check_factors("sgmv", A, B)
    with pytest.raises(TypeError, match="differ in dtype"):
        tbgmv._check_factors("sgmv", A, B.to(torch.float16))


@pytest.mark.parametrize("d_in,max_splits,want", [
    (4096, 16, 4), (1536, 16, 2), (24, 16, 1), (1024, 16, 1), (1025, 16, 2),
    (100_000, 16, 16), (8192, 4, 4)])
def test_sgmv_split_plan(d_in, max_splits, want):
    splits = tsgmv.split_plan(d_in, max_splits)
    assert splits == want
    # each item contracts at most SPLIT_ROWS rows unless the splits run out,
    # and the plan takes the fewest splits that do
    assert -(-d_in // splits) <= tsgmv.SPLIT_ROWS or splits == max_splits
    assert splits == 1 or -(-d_in // (splits - 1)) > tsgmv.SPLIT_ROWS


# ------------------------------ dispatch ------------------------------- #
KERNELS = {"bgmv_ranked": tbgmv.bgmv_ranked, "sgmv": tsgmv.sgmv,
           "sgmv_ranked": tsgmv.sgmv_ranked, "fused_sgmv": tfused.fused_sgmv,
           "fused_sgmv_ranked": tfused.fused_sgmv_ranked, "gmm": tgmm.gmm,
           "sgmv_rank_grouped": tsgmv.sgmv_rank_grouped}


@pytest.mark.parametrize("name", TWINS)
def test_cpu_tensors_take_the_twin_and_wrappers_refuse_them(name):
    args = _t(_inputs("sgmv_ranked" if name == "sgmv_rank_grouped"
                      else name))
    counters = [tbgmv.bgmv_ranked, tsgmv.sgmv, tsgmv.sgmv_ranked,
                tfused.fused_sgmv, tfused.fused_sgmv_ranked, tgmm.gmm]
    before = [c.launches for c in counters]
    assert torch.equal(getattr(tops, name)(*args),
                       getattr(tref, f"{name}_ref")(*args))
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="CUDA"):
        KERNELS[name](*args)


# ----------------------------- entry point ----------------------------- #
def test_kernel_path_holds_its_invariants_on_cpu():
    res = tlaunch.run(device="cpu", reduced=True)
    assert res["device"] == "cpu"
    bad = [i["name"] for i in res["invariants"] if not i["ok"]]
    assert not bad, bad
    assert len(res["invariants"]) == 13
    c = res["counts"]
    assert c["rows_kept"] + c["rows_dropped"] == c["rows"]
    assert c["rank_buckets"] == len(c["ranks_present"]) == 4
    assert res["expected_launches"]["sgmv"] == 1 + c["rank_buckets"]
    assert set(res["cases"]) == set(res["outputs"])
    for name, out in res["outputs"].items():
        assert out.dtype == torch.float32 and torch.isfinite(out).all(), name
    # the same inputs through the twins give the same outputs
    for name, (op, args, _) in res["cases"].items():
        assert torch.equal(getattr(tref, f"{op}_ref")(*args),
                           res["outputs"][name]), name


def test_kernel_path_work_counts_this_runs_data():
    res = tlaunch.run(device="cpu", reduced=True)
    c, cases = res["counts"], res["cases"]
    d = res["outputs"]["bgmv"].shape[1]
    assert {n for n, case in cases.items() if case.work is None} == \
        {"bgmv_expert_down", "bgmv_expert_up"}
    work = {n: case.work for n, case in cases.items() if case.work}
    assert work["bgmv"].x_bytes == c["rows"] * d * 2          # bf16
    assert work["sgmv"].x_bytes == c["rows_kept"] * d * 2
    assert work["sgmv_rank_grouped"] == work["sgmv_ranked"]
    for ranked, padded in [("bgmv_ranked", "bgmv"), ("sgmv_ranked", "sgmv"),
                           ("fused_sgmv_ranked", "fused_sgmv_down")]:
        assert work[ranked].w_bytes < work[padded].w_bytes, ranked
        assert work[ranked].operations < work[padded].operations, ranked
    # bgmv's factor bytes: each distinct adapter's A and B at the pool rank
    seg_ad = cases["sgmv"].args[1]
    assert work["bgmv"].w_bytes == int((seg_ad >= 0).sum()) * \
        tlaunch.R_POOL * 2 * d * 2
    xe, w, gs = cases["gmm_gate"].args
    assert work["gmm_gate"].x_bytes == int(gs.sum()) * xe.shape[2] * 2
    assert work["gmm_gate"].w_bytes == c["gmm_experts_used"] * \
        w.shape[1] * w.shape[2] * 2
    assert work["gmm_gate"].out_bytes == xe.shape[0] * xe.shape[1] * \
        w.shape[2] * 4
    for n, wk in work.items():
        assert wk.bytes == wk.x_bytes + wk.w_bytes + wk.idx_bytes + \
            wk.out_bytes > 0 and wk.operations > 0, n


def test_kernel_entry_point_needs_cuda_unless_told_cpu(monkeypatch, capsys):
    assert tlaunch.main(["--device", "cpu", "--reduced"]) == 0
    assert '"ok": true' in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.run(reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--reduced"])


def test_zipf_rank_mix_matches_the_reference_draw():
    from benchmarks.bench_kernels import zipf_rank_mix
    from repro.serving.workload import zipf_popularity
    from repro_torch.serving import workload
    np.testing.assert_array_equal(tlaunch.zipf_rank_mix(512, 0),
                                  zipf_rank_mix(512, 0))
    np.testing.assert_array_equal(workload.zipf_popularity(64, 1.2),
                                  zipf_popularity(64, 1.2))


def test_new_modules_import_without_jax():
    mods = ["repro_torch.kernels.sgmv", "repro_torch.kernels.fused",
            "repro_torch.kernels.gmm", "repro_torch.kernels.ops",
            "repro_torch.launch.kernels", "repro_torch.serving.workload"]
    code = ("import sys, importlib; sys.modules['jax'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules), 'the port imported the JAX package'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------ on the card ---------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (CUDA kernel)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", TWINS)
def test_kernel_matches_twin_on_card(cuda_device, dtype, name):
    args = _t(_inputs("sgmv_ranked" if name == "sgmv_rank_grouped"
                      else name), cuda_device, dtype)
    got = KERNELS[name](*args)
    torch.testing.assert_close(got, getattr(tref, f"{name}_ref")(*args),
                               rtol=0, atol=1e-5)
    assert torch.equal(got, KERNELS[name](*args))       # same bits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ranked_kernels_equal_padded_on_card(cuda_device, dtype):
    for ranked, padded in [(tbgmv.bgmv_ranked, tbgmv.bgmv),
                           (tsgmv.sgmv_ranked, tsgmv.sgmv),
                           (tfused.fused_sgmv_ranked, tfused.fused_sgmv)]:
        name = ranked.__name__
        args = _t(_inputs(name), cuda_device, dtype)
        rest = args[:4] if name == "bgmv_ranked" else args[:-3] + args[-2:]
        assert torch.equal(ranked(*args), padded(*rest)), name
    seg, ad, rank, A, B = _t(_inputs("sgmv_ranked"), cuda_device, dtype)
    order = torch.argsort(torch.where(ad >= 0, rank, 99), stable=True)
    args = (seg[order], ad[order], rank[order], A, B)
    before = tsgmv.sgmv.launches
    assert torch.equal(tsgmv.sgmv_rank_grouped(*args),
                       tsgmv.sgmv_ranked(*args))
    assert tsgmv.sgmv.launches - before == 3      # ranks 2, 4 and 8


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgmv_rank_buckets_of_any_width_on_card(cuda_device, dtype):
    # a rank-24 pool: the bf16 kernel splits 3 column groups over its
    # threads, the f32 one 6, and the rank-20 bucket 3 or 5
    rng = np.random.default_rng(5)
    ranks = np.array([4, 20, 24], np.int32)
    A = (rng.standard_normal((3, 32, 24)) / 24).astype(np.float32)
    B = (rng.standard_normal((3, 24, 40)) * 0.1).astype(np.float32)
    for n, k in enumerate(ranks):
        A[n, :, k:] = 0.0
        B[n, k:] = 0.0
    seg = rng.standard_normal((4, 8, 32)).astype(np.float32)
    ad = np.array([0, 1, 2, -1], np.int32)
    rank = np.array([4, 20, 24, 0], np.int32)
    args = _t((seg, ad, rank, A, B), cuda_device, dtype)
    got = tsgmv.sgmv_ranked(*args)
    torch.testing.assert_close(got, tref.sgmv_ranked_ref(*args), rtol=0,
                               atol=1e-5)
    before = tsgmv.sgmv.launches
    torch.testing.assert_close(tsgmv.sgmv_rank_grouped(*args), got, rtol=0,
                               atol=1e-5)
    assert tsgmv.sgmv.launches - before == 3


@pytest.mark.gpu
def test_kernel_path_on_card(cuda_device):
    counters = {"bgmv": tbgmv.bgmv, "bgmv_expert": tbgmv.bgmv_expert,
                **{k: v for k, v in KERNELS.items()
                   if k != "sgmv_rank_grouped"}}
    for fn in counters.values():
        fn.launches = 0
    res = tlaunch.run(reduced=True)
    assert res["device"].startswith("cuda")
    assert all(i["ok"] for i in res["invariants"]), res["invariants"]
    assert {k: fn.launches for k, fn in counters.items()} == \
        res["expected_launches"]


# ---------------------- any width and any order, on the card ---------------- #
# (pool rank, d_in, d_out): odd ranks, d_in and d_out that are not whole
# 16-byte vectors in bf16 or f32
ODD_SHAPES = [(4, 24, 40), (6, 37, 44), (20, 24, 44), (24, 37, 45)]
SEGMENT_OPS = ["sgmv", "sgmv_ranked", "fused_sgmv", "fused_sgmv_ranked",
               "sgmv_rank_grouped"]
ODD_OPS = SEGMENT_OPS + ["bgmv", "bgmv_ranked", "bgmv_expert"]


def _odd_inputs(name, r, d_in, d_out, seed=13):
    """Numpy arguments of one op at pool rank r, d_in and d_out; true ranks
    r, r - 3 (at least 1), 1 and r in a prefix-zero pool; padding rows of
    the segments all zero, one inactive segment."""
    rng = np.random.default_rng(seed)
    ranks = np.array([r, max(1, r - 3), 1, r], np.int32)
    fused = name.startswith("fused") or name == "bgmv_expert"
    lead = (4, 3) if fused else (4,)
    A = (rng.standard_normal(lead + (d_in, r)) / np.sqrt(d_in)
         ).astype(np.float32)
    B = (rng.standard_normal(lead + (r, d_out)) * 0.1).astype(np.float32)
    for n, k in enumerate(ranks):
        A[n, ..., k:] = 0.0
        B[n, ..., k:, :] = 0.0
    if name.startswith("bgmv"):
        x = rng.standard_normal((9, d_in)).astype(np.float32)
        ids = np.array([0, -1, 3, 1, 2, -1, 3, 0, 2], np.int32)
        if name == "bgmv":
            return x, A, B, ids
        if name == "bgmv_ranked":
            return x, A, B, ids, ranks
        eids = rng.integers(0, 3, 9).astype(np.int32)
        return (x, A, B, ids, eids,
                np.where(ids >= 0, ranks[np.maximum(ids, 0)], 0
                         ).astype(np.int32))
    seg = rng.standard_normal((5, 6, d_in)).astype(np.float32)
    seg[1, 2:] = 0.0
    seg[3, :4] = 0.0                  # data rows not at the segment's start
    slot = np.array([3, 1, -1, 0, 2], np.int32)
    rank = np.where(slot >= 0, ranks[np.maximum(slot, 0)], 0
                    ).astype(np.int32)
    if not fused:
        return ((seg, slot, A, B) if name == "sgmv"
                else (seg, slot, rank, A, B))
    eid = np.array([2, 0, 1, 1, 2], np.int32)
    return ((seg, slot, eid, A, B) if name == "fused_sgmv"
            else (seg, slot, eid, rank, A, B))


ODD_KERNELS = {**KERNELS, "bgmv": tbgmv.bgmv,
               "bgmv_expert": tbgmv.bgmv_expert}
ODD_TWINS = {"bgmv": tref.bgmv_ref, "bgmv_expert": tref.bgmv_expert_ref}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ODD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ODD_OPS)
def test_lora_kernels_take_any_width_on_card(cuda_device, dtype, name,
                                             shape):
    args = _t(_odd_inputs(name, *shape), cuda_device, dtype)
    got = ODD_KERNELS[name](*args)
    want = ODD_TWINS.get(name, getattr(tref, f"{name}_ref", None))(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got, ODD_KERNELS[name](*args))    # same bits
    if name not in ("bgmv", "bgmv_ranked", "bgmv_expert"):
        assert torch.all(got[args[1] < 0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["full", "late_rows", "all_inactive",
                                  "all_padding", "splits"])
@pytest.mark.parametrize("name", SEGMENT_OPS[:4])
def test_segment_kernel_edge_cases_on_card(cuda_device, dtype, case, name):
    """A full segment (cap rows with data, 80: two row groups), data rows
    at a segment's end, every segment inactive, every row padding (exact
    zeros), and a d_in that splits a segment's shrink into three items."""
    d_in = 3000 if case == "splits" else 40
    cap = 80 if case == "full" else 16
    args = list(_t(_odd_inputs(name, 24, d_in, 72), cuda_device, dtype))
    S = args[0].shape[0]
    seg = torch.randn((S, cap, d_in), generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device).to(dtype)
    if case == "late_rows":
        seg[:, :cap - 3] = 0.0
    if case == "all_padding":
        seg.zero_()
    args[0] = seg
    if case == "all_inactive":
        args[1] = torch.full_like(args[1], -1)
    if case == "splits":
        assert tsgmv.split_plan(d_in) == 3
    got = KERNELS[name](*args)
    torch.testing.assert_close(got, getattr(tref, f"{name}_ref")(*args),
                               rtol=0, atol=1e-5)
    assert torch.equal(got, KERNELS[name](*args))
    if case in ("all_inactive", "all_padding"):
        assert torch.all(got == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgmv_rank_grouped_any_order_on_card(cuda_device, dtype):
    """Segments in adapter order, ranks interleaved: one launch per
    distinct nonzero rank, equal to sgmv_ranked; inactive segments and an
    active one of rank 0 exact zeros."""
    rng = np.random.default_rng(17)
    ranks = np.array([4, 20, 6, 24, 4, 20, 0], np.int32)
    A = (rng.standard_normal((7, 48, 24)) / 7).astype(np.float32)
    B = (rng.standard_normal((7, 24, 44)) * 0.1).astype(np.float32)
    for n, k in enumerate(ranks[:6]):
        A[n, :, k:] = 0.0
        B[n, k:] = 0.0
    seg = rng.standard_normal((9, 8, 48)).astype(np.float32)
    ad = np.array([0, 1, -1, 2, 6, 3, 4, -1, 5], np.int32)
    rank = np.where(ad >= 0, ranks[np.maximum(ad, 0)], 0).astype(np.int32)
    args = _t((seg, ad, rank, A, B), cuda_device, dtype)
    before = tsgmv.sgmv.launches
    got = tsgmv.sgmv_rank_grouped(*args)
    assert tsgmv.sgmv.launches - before == 4        # ranks 4, 6, 20, 24
    torch.testing.assert_close(got, tsgmv.sgmv_ranked(*args), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(got, tref.sgmv_ranked_ref(*args), rtol=0,
                               atol=1e-5)
    assert torch.all(got[args[1] < 0] == 0) and torch.all(got[4] == 0)
    assert torch.equal(got, tsgmv.sgmv_rank_grouped(*args))
