"""Parity of the port's kernels (``repro_torch.kernels``) with the JAX
reference's Pallas kernels and oracles.

On the CPU the port's wrappers take their plain PyTorch versions; those are
held against the reference's Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and jnp oracles on the same numpy inputs,
within 1e-6 abs: the f32 rounding spread between two summation orders at
these shapes. The CUDA kernels themselves run only on the card: the tests
marked ``gpu`` hold them against the plain versions there and skip here.
"""
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
