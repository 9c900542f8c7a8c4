"""Parity of the port's kernels (``repro_torch.kernels``) with the JAX
reference's Pallas kernels and oracles.

On the CPU the port's wrappers take their plain PyTorch versions; those are
held against the reference's Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and jnp oracles on the same numpy inputs,
within 1e-6 abs: the f32 rounding spread between two summation orders at
these shapes. The CUDA kernels themselves run only on the card: the tests
marked ``gpu`` hold them against the plain versions there and skip here.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import bgmv as tbgmv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged as tpaged
from repro_torch.kernels import ref as tref

TOL = 1e-6


def _paged_inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    B, KV, G, hd, P, ps, nb = 5, 2, 3, 16, 22, 4, 4
    q = rng.standard_normal((B, KV, G, hd)).astype(dtype)
    k = rng.standard_normal((P, ps, KV, hd)).astype(dtype)
    v = rng.standard_normal((P, ps, KV, hd)).astype(dtype)
    bt = rng.permutation(P)[: B * nb].reshape(B, nb).astype(np.int32)
    bt[1, 2:] = -1          # unallocated tail
    bt[2, 1] = -1           # hole inside the context
    bt[4, :] = -1           # no page at all: exact zeros
    pos = np.array([15, 7, 9, -1, 3], np.int32)   # row 3 inactive
    return q, k, v, bt, pos


def _jnp(*arrs):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("window", [0, 6])
def test_paged_attention_ref_matches_pallas_and_jnp_oracle(monkeypatch,
                                                           window):
    q, k, v, bt, pos = _paged_inputs()
    got = tref.paged_attention_ref(*map(torch.from_numpy, (q, k, v, bt, pos)),
                                   window=window).numpy()
    oracle = np.asarray(jref.paged_attention_ref(*_jnp(q, k, v, bt, pos),
                                                 window))
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    pallas = np.asarray(jops.paged_attention(*_jnp(q, k, v, bt, pos),
                                             window=window))
    assert got.shape == (5, 2, 3, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    assert np.all(got[3] == 0.0) and np.all(got[4] == 0.0)


def _bgmv_inputs(seed=1):
    rng = np.random.default_rng(seed)
    T, N, E, d_in, r, d_out = 7, 3, 2, 16, 8, 24
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    A = (rng.standard_normal((N, E, d_in, r)) / r).astype(np.float32)
    B = (rng.standard_normal((N, E, r, d_out)) * 0.1).astype(np.float32)
    ids = np.array([0, -1, 2, 1, -1, 2, 0], np.int32)
    eids = np.array([1, 0, 0, 1, 1, 1, 0], np.int32)
    return x, A, B, ids, eids


def test_bgmv_expert_ref_matches_pallas_and_jnp_oracle(monkeypatch):
    x, A, B, ids, eids = _bgmv_inputs()
    got = tref.bgmv_expert_ref(*map(torch.from_numpy,
                                    (x, A, B, ids, eids))).numpy()
    oracle = np.asarray(jref.bgmv_expert_ref(*_jnp(x, A, B, ids, eids)))
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    pallas = np.asarray(jops.bgmv_expert(*_jnp(x, A, B, ids, eids)))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    assert np.all(got[ids < 0] == 0.0)


def test_bgmv_expert_ref_rank_mask_is_column_modulus():
    """With ranks, h keeps column c iff (c % r_mod) < rank: the masked
    product equals the unmasked one on factors zeroed past the rank in each
    r_mod-wide block (the fused gate|up hook layout)."""
    x, A, B, ids, eids = map(torch.from_numpy, _bgmv_inputs())
    ranks = torch.tensor([1, 4, 2, 3, 4, 4, 2], dtype=torch.int32)
    got = tref.bgmv_expert_ref(x, A, B, ids, eids, ranks, r_mod=4)
    want = torch.zeros_like(got)
    for t in range(x.shape[0]):
        if ids[t] < 0:
            continue
        keep = (torch.arange(8) % 4) < ranks[t]
        a = A[ids[t], eids[t]] * keep[None, :]
        want[t] = (x[t] @ a) @ B[ids[t], eids[t]]
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


def test_ops_take_the_plain_version_on_the_cpu():
    q, k, v, bt, pos = map(torch.from_numpy, _paged_inputs())
    x, A, B, ids, eids = map(torch.from_numpy, _bgmv_inputs())
    before = (tpaged.paged_attention.launches, tbgmv.bgmv_expert.launches)
    assert torch.equal(tops.paged_attention(q, k, v, bt, pos, window=6),
                       tref.paged_attention_ref(q, k, v, bt, pos, 6))
    assert torch.equal(tops.bgmv_expert(x, A, B, ids, eids),
                       tref.bgmv_expert_ref(x, A, B, ids, eids))
    assert (tpaged.paged_attention.launches,
            tbgmv.bgmv_expert.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor never reaches C."""
    q, k, v, bt, pos = map(torch.from_numpy, _paged_inputs())
    x, A, B, ids, eids = map(torch.from_numpy, _bgmv_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        tpaged.paged_attention(q, k, v, bt, pos)
    with pytest.raises(ValueError, match="CUDA"):
        tbgmv.bgmv_expert(x, A, B, ids, eids)


def test_split_plan_covers_every_page():
    for B, KV, nb in [(8, 4, 16), (8, 4, 128), (1, 1, 1), (3, 2, 0),
                      (64, 8, 7)]:
        pps, n_split = tpaged.split_plan(B, KV, nb)
        assert pps >= 1 and n_split >= 1
        assert pps * n_split >= nb and pps * (n_split - 1) < max(nb, 1)


def test_split_plan_fixes_a_small_split():
    """Splits of 4 or 8 pages, whatever the context: the serving cell's
    tables (nb = 16) get 4 pages a split, 2048-token ones (nb = 128) 8."""
    assert tpaged.split_plan(8, 4, 16) == (4, 4)
    assert tpaged.split_plan(8, 4, 128) == (8, 16)
    for nb in range(1, 300, 7):
        pps, _ = tpaged.split_plan(8, 4, nb)
        assert pps == min(nb, pps) and pps in (1, 4, 8)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CSRC = pathlib.Path(tbgmv.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_profile_names_every_kernel_of_a_source(source):
    """The on-card profile reads each port kernel's ms/step by the names
    chip_smoke.port_kernels takes from the sources: every __global__
    function of each source, once, and no name twice across sources."""
    found = _chip_smoke().port_kernels(CSRC)
    text = (CSRC / source).read_text()
    names = found[source]
    assert names and len(names) == len(set(names)) == text.count("__global__")
    for name in names:
        assert len(re.findall(rf"(?<!\w){name}(?!\w)", text)) >= 2  # used
        assert all(name not in found[other] for other in found
                   if other != source)


@pytest.mark.parametrize("r, dtype, d_out", [
    (24, torch.bfloat16, 16), (512, torch.bfloat16, 16),
    (20, torch.float32, 16), (20, torch.bfloat16, 16),
    (24, torch.bfloat16, 10), (4, torch.bfloat16, 44),
    (6, torch.float32, 45)])
def test_factor_check_takes_any_whole_vector_rank(r, dtype, d_out):
    """bgmv.cu, bgmv_expert.cu and sgmv.cu take any rank and any d_out (a
    piece of a row that is not a whole 16-byte vector is read one value at
    a time): the check asks only for one dtype and aligned factors."""
    A = torch.zeros((1, 1, 8, r + 8), dtype=dtype)
    B = torch.zeros((1, 1, r, d_out + 8), dtype=dtype)
    tbgmv._check_factors("bgmv_expert", A[..., :r], B[..., :d_out])
    with pytest.raises(TypeError, match="differ in dtype"):
        tbgmv._check_factors("bgmv", A, B.to(torch.float16))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tbgmv._check_factors("bgmv", A.reshape(-1)[1:9], B)


# ------------------------------ on the card ----------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (CUDA kernel)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain_on_card(cuda_device, dtype):
    q, k, v, bt, pos = (torch.from_numpy(a).to(cuda_device)
                        for a in _paged_inputs())
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    for window in (0, 6):
        got = tpaged.paged_attention(q, k, v, bt, pos, window=window)
        want = tref.paged_attention_ref(q, k, v, bt, pos, window)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bgmv_expert_kernel_matches_plain_on_card(cuda_device, dtype):
    x, A, B, ids, eids = (torch.from_numpy(a).to(cuda_device)
                          for a in _bgmv_inputs())
    x, A, B = x.to(dtype), A.to(dtype), B.to(dtype)
    ranks = torch.tensor([1, 4, 2, 3, 4, 4, 2], dtype=torch.int32,
                         device=cuda_device)
    torch.testing.assert_close(tbgmv.bgmv_expert(x, A, B, ids, eids),
                               tref.bgmv_expert_ref(x, A, B, ids, eids),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(
        tbgmv.bgmv_expert(x, A, B, ids, eids, ranks, 4),
        tref.bgmv_expert_ref(x, A, B, ids, eids, ranks, 4), rtol=0, atol=1e-5)


def _paged_tile_inputs(nb, dtype, device, seed=3):
    """The MMA tile shape (G = 16, hd = 128, pages of 16) with contexts that
    span several splits, a hole in a block table, a page id past the pool,
    an inactive row and a row without pages."""
    rng = np.random.default_rng(seed)
    B, KV, G, hd, ps = 5, 2, 16, 128, 16
    P = B * nb + 4
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    v = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    bt = rng.permutation(P)[: B * nb].reshape(B, nb).astype(np.int32)
    bt[0, 3] = -1                 # a hole inside the context
    bt[1, 1] = P + 7              # past the pool: clamped to P - 1
    bt[4, :] = -1                 # no page at all
    pos = np.array([nb * ps - 1, nb * ps // 2 + 5, -1, 37, nb * ps - 3],
                   np.int32)      # row 2 inactive
    tensors = [torch.from_numpy(a).to(device) for a in (q, k, v, bt, pos)]
    return [t.to(dtype) if t.is_floating_point() else t for t in tensors]


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [24, 216])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_at_the_mma_tile(cuda_device, dtype, nb):
    """nb = 24 runs 4-page splits (one 16-key unit a warp), nb = 216
    8-page splits (two units a warp, the hole skipping one; split_plan)."""
    q, k, v, bt, pos = _paged_tile_inputs(nb, dtype, cuda_device)
    for window in (0, 40):
        got = tpaged.paged_attention(q, k, v, bt, pos, window=window)
        want = tref.paged_attention_ref(q, k, v, bt, pos, window)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        assert torch.all(got[2] == 0) and torch.all(got[4] == 0)


@pytest.mark.gpu
def test_paged_attention_kernel_repeats_bit_for_bit(cuda_device):
    q, k, v, bt, pos = _paged_tile_inputs(216, torch.bfloat16, cuda_device)
    first = tpaged.paged_attention(q, k, v, bt, pos, window=40)
    again = tpaged.paged_attention(q, k, v, bt, pos, window=40)
    assert torch.equal(first, again)


def _hook_inputs(case, device, seed=4):
    """bgmv_expert at the up hook's widths (d_in 4096, rank 64 = 2 x 32,
    per-row true ranks) on 256 rows: "ranks" spreads 40 active rows over
    2 slots x 4 experts, "shared" puts 60 rows on one (slot, expert) pair,
    "none" has no active row, "one" a single active row."""
    rng = np.random.default_rng(seed)
    T, N, E, d_in, r, d_out = 256, 2, 4, 4096, 64, 512
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    A = (rng.standard_normal((N, E, d_in, r)) / r).astype(np.float32)
    B = (rng.standard_normal((N, E, r, d_out)) * 0.01).astype(np.float32)
    ids = np.full(T, -1, np.int32)
    eids = rng.integers(0, E, T).astype(np.int32)
    if case == "ranks":
        ids[rng.permutation(T)[:40]] = rng.integers(0, N, 40)
    elif case == "shared":
        rows = rng.permutation(T)[:60]
        ids[rows], eids[rows] = 1, 2
    elif case == "one":
        ids[77] = 0
    ranks = rng.choice([8, 16, 32, 5], T).astype(np.int32)
    tensors = [torch.from_numpy(a).to(device)
               for a in (x, A, B, ids, eids, ranks)]
    return [t.bfloat16() if t.is_floating_point() else t for t in tensors]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ranks", "shared", "none", "one"])
def test_bgmv_expert_kernel_at_the_hook_widths(cuda_device, case):
    x, A, B, ids, eids, ranks = _hook_inputs(case, cuda_device)
    for rk, r_mod in ((ranks, 32), (None, 0)):
        got = tbgmv.bgmv_expert(x, A, B, ids, eids, rk, r_mod)
        want = tref.bgmv_expert_ref(x, A, B, ids, eids, rk, r_mod)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        assert torch.all(got[ids < 0] == 0)
        assert torch.equal(got, tbgmv.bgmv_expert(x, A, B, ids, eids, rk,
                                                  r_mod))


@pytest.mark.gpu
@pytest.mark.parametrize("r, dtype", [(24, torch.bfloat16),
                                      (512, torch.bfloat16),
                                      (20, torch.float32),
                                      (4, torch.bfloat16),
                                      (6, torch.float32)])
def test_bgmv_expert_kernel_takes_any_rank_width(cuda_device, r, dtype):
    """A rank whose r / VEC column groups do not divide a warp (24 in bf16,
    20 in f32), one with more groups than a warp has lanes (512), and ranks
    that are not a whole number of 16-byte vectors (4 in bf16, 6 in f32:
    read one value at a time)."""
    rng = np.random.default_rng(5)
    T, N, E, d_in, d_out = 96, 2, 3, 200, 48
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    A = (rng.standard_normal((N, E, d_in, r)) / r).astype(np.float32)
    B = (rng.standard_normal((N, E, r, d_out)) * 0.1).astype(np.float32)
    ids = np.where(rng.random(T) < 0.3, rng.integers(0, N, T), -1)
    eids = rng.integers(0, E, T)
    ranks = rng.integers(1, r // 2 + 1, T)
    x, A, B = (torch.from_numpy(a).to(cuda_device, dtype) for a in (x, A, B))
    ids, eids, ranks = (torch.from_numpy(a.astype(np.int32)).to(cuda_device)
                        for a in (ids, eids, ranks))
    for rk, r_mod in ((ranks, r // 2), (None, 0)):
        torch.testing.assert_close(
            tbgmv.bgmv_expert(x, A, B, ids, eids, rk, r_mod),
            tref.bgmv_expert_ref(x, A, B, ids, eids, rk, r_mod),
            rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d_in, r, dtype", [
    (4096, 64, torch.bfloat16), (1536, 32, torch.bfloat16),
    (4096, 32, torch.bfloat16), (16, 8, torch.float32),
    (16, 8, torch.bfloat16), (1, 8, torch.bfloat16),
    (100000, 8, torch.bfloat16), (4096, 2048, torch.bfloat16),
    (1536, 24, torch.bfloat16)])
def test_bgmv_expert_splits_cover_every_row(cuda_device, d_in, r, dtype):
    """csrc/bgmv_expert.cu plans the shrink's d_in splits (the wrapper sizes
    its scratch from them): every row of d_in lies in exactly one split, at
    most 32 splits (h sums them in one batch of loads), each two batches of
    16 loads a lane unless the cap binds."""
    lib = tbgmv._lib("bgmv_expert", 9, 7)
    splits = lib.bgmv_expert_splits(1 if dtype == torch.bfloat16 else 0,
                                    d_in, r)
    chunk = -(-d_in // splits)
    assert 1 <= splits <= 32
    rows = sorted(d for s in range(splits)
                  for d in range(s * chunk, min(d_in, (s + 1) * chunk)))
    assert rows == list(range(d_in))
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    lanes = max(1, 32 // (r // vec))
    if splits < 32:
        assert chunk <= 16 * 2 * lanes
