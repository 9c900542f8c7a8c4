"""The mesh-sharded serving plane on the card (every test is ``gpu`` and
skips without one; the CPU tests of the plane, against the JAX package,
are ``tests/test_torch_mesh.py``):

  - every kernel wrapper launches on its operands' card: each kernel called
    on cuda:1 while cuda:0 is current gives the bits of the same call on
    cuda:0 (two visible cards, else it skips)
  - the split the mesh plane relies on: ``gmm`` over two and four expert
    blocks (the decode dispatch and a prefill chunk) and ``bgmv_expert``
    over two row blocks give the bits of one launch, concatenated or each
    written into its slice of one output (``out=``)
  - serving the reduced qwen3-moe config: a (2, 1) grid on one card (and,
    where two are visible, over cuda:0 and cuda:1) gives the tokens
    without a mesh on both transports, one dispatch a fused step; the
    front door's mesh takes distinct cards, so it raises "needs 2
    devices" on one card, and on two both transports serve it with the
    tokens without a mesh

Weights are drawn with torch from a seed (no JAX here)."""
import pytest
import torch

from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import bgmv, fused, gmm, ops, paged, sgmv
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe
from repro_torch.serving.api import ServeConfig, build_system
from repro_torch.serving.engine import Engine

SPECS = [(0, 0.0, 5, 6), (1, 0.0, 4, 4), (2, 2.0, 6, 5), (3, 5.0, 3, 4)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (CUDA kernels)")
    return torch.device("cuda", 0)


def _kernel_calls(dev, seed=0):
    """One call of every kernel wrapper on ``dev``: name -> thunk."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(shape, generator=g) * 0.1).to(
            torch.bfloat16).to(dev)

    def ints(hi, *shape, lo=0):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    T, d_in, r, d_out, N, E = 8, 256, 16, 256, 3, 4
    x, A, B = rnd(T, d_in), rnd(N, d_in, r), rnd(N, r, d_out)
    Ae, Be = rnd(N, E, d_in, r), rnd(N, E, r, d_out)
    ids, eids = ints(N, T, lo=-1), ints(E, T)
    ranks_n, ranks_t = ints(r + 1, N, lo=1), ints(r + 1, T, lo=1)
    S, cap = 4, 16
    seg = rnd(S, cap, d_in)
    seg_ids, seg_eid = ints(N, S, lo=-1), ints(E, S)
    seg_rank = ints(r + 1, S, lo=1)
    q = rnd(2, 2, 4, 64)
    kp, vp = rnd(8, 16, 2, 64), rnd(8, 16, 2, 64)
    bt = torch.tensor([[0, 1, -1], [2, 3, 4]], dtype=torch.int32).to(dev)
    pos = torch.tensor([20, 40], dtype=torch.int32).to(dev)
    xe, w = rnd(E, 8, d_in), rnd(E, d_in, d_out)
    gs = torch.tensor([8, 0, 3, 5], dtype=torch.int32).to(dev)
    return {
        "paged_attention": lambda: paged.paged_attention(q, kp, vp, bt, pos),
        "bgmv": lambda: bgmv.bgmv(x, A, B, ids),
        "bgmv_ranked": lambda: bgmv.bgmv_ranked(x, A, B, ids, ranks_n),
        "bgmv_expert": lambda: bgmv.bgmv_expert(x, Ae, Be, ids, eids,
                                                ranks_t, r),
        "sgmv": lambda: sgmv.sgmv(seg, seg_ids, A, B),
        "sgmv_ranked": lambda: sgmv.sgmv_ranked(seg, seg_ids, seg_rank, A,
                                                B),
        "fused_sgmv": lambda: fused.fused_sgmv(seg, seg_ids, seg_eid, Ae,
                                               Be),
        "fused_sgmv_ranked": lambda: fused.fused_sgmv_ranked(
            seg, seg_ids, seg_eid, seg_rank, Ae, Be),
        "gmm": lambda: gmm.gmm(xe, w, gs),
    }


@pytest.mark.gpu
def test_kernels_launch_on_their_operands_card(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two visible cards")
    on0 = _kernel_calls(torch.device("cuda", 0))
    on1 = _kernel_calls(torch.device("cuda", 1))
    with torch.cuda.device(0):
        for name in on0:
            want = on0[name]()
            got = on1[name]()
            assert got.device == torch.device("cuda", 1), name
            torch.cuda.synchronize(1)
            assert torch.equal(got.cpu(), want.cpu()), name


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [8, 64], ids=["decode", "prefill"])
def test_gmm_over_expert_blocks_gives_one_launchs_bits(cuda_device, tokens):
    """8 tokens (the decode dispatch) or 64 (a prefill chunk), top-8 over 32
    experts, bf16: two and four expert blocks, concatenated, == one gmm
    over all experts, bit for bit."""
    E, K, d, f = 32, 8, 512, 384
    g = torch.Generator().manual_seed(tokens)
    C = tokens * K
    xe = torch.randn((E, C, d), generator=g).to(torch.bfloat16).to(
        cuda_device)
    w = (torch.randn((E, d, f), generator=g) * 0.05).to(torch.bfloat16).to(
        cuda_device)
    gs = torch.randint(0, C + 1, (E,), generator=g, dtype=torch.int32)
    gs[3] = 0
    gs = gs.to(cuda_device)
    want = ops.gmm(xe, w, gs)
    into = torch.full_like(want, float("nan"))     # every element is written
    assert ops.gmm(xe, w, gs, out=into) is into and torch.equal(into, want)
    for n in (2, 4):
        blocks = tmoe.ExpertBlocks.cut(w, [cuda_device] * n)
        assert torch.equal(tmoe.expert_gmm(xe, blocks, gs), want), n


@pytest.mark.gpu
def test_bgmv_expert_over_row_blocks_gives_one_calls_bits(cuda_device):
    """The EP x PP server's split: two row blocks of a hook == one call."""
    T, d_in, r, d_out, N, E = 512, 1024, 32, 768, 4, 8
    g = torch.Generator().manual_seed(5)
    x = torch.randn((T, d_in), generator=g).to(torch.bfloat16).to(
        cuda_device)
    A = (torch.randn((N, E, d_in, r), generator=g) * 0.05).to(
        torch.bfloat16).to(cuda_device)
    B = (torch.randn((N, E, r, d_out), generator=g) * 0.05).to(
        torch.bfloat16).to(cuda_device)
    ids = torch.randint(-1, N, (T,), generator=g, dtype=torch.int32).to(
        cuda_device)
    eids = (torch.arange(T, dtype=torch.int32) // (T // E)).to(cuda_device)
    ranks = torch.randint(1, r + 1, (T,), generator=g,
                          dtype=torch.int32).to(cuda_device)
    want = ops.bgmv_expert(x, A, B, ids, eids, ranks, r)
    h = T // 2
    halves = (slice(0, h), slice(h, T))
    got = torch.cat([ops.bgmv_expert(x[s].contiguous(), A, B, ids[s],
                                     eids[s], ranks[s], r) for s in halves])
    assert torch.equal(got, want)
    into = torch.full_like(want, float("nan"))     # every row is written
    for s in halves:
        ops.bgmv_expert(x[s].contiguous(), A, B, ids[s], eids[s], ranks[s],
                        r, out=into[s])
    assert torch.equal(into, want)


def _served(system):
    hs = [system.submit(adapter_id=a, prompt_len=p, max_new_tokens=o,
                        arrival=t) for a, t, p, o in SPECS]
    system.drain()
    return {h.rid: tuple(h.tokens) for h in hs}


@pytest.mark.gpu
def test_mesh_serving_on_cards(cuda_device):
    ranks = (2, 8, 4, 8)
    cfg, params = serve.model("qwen3-moe-235b-a22b", reduced=True,
                              device=cuda_device)
    traffic = serve.Traffic(n_requests=4, adapter_ranks=ranks,
                            prompt_len=(3, 9), new_tokens=5, first_wave=3,
                            second_wave_after=2)
    requests = serve.make_requests(cfg, traffic)
    ecfg = serve.ENGINE
    grids = [[cuda_device] * 2]
    if torch.cuda.device_count() >= 2:
        grids.append([cuda_device, torch.device("cuda", 1)])
    got = {}
    for tr in ("host", "fused"):
        for devs in [None] + grids:
            ctx = None if devs is None else tsteps.expert_parallel_ctx(
                tmesh.make_serve_mesh(2, 1, devs), cfg)
            lora = serve.build_pool(cfg, ranks, 2, device=cuda_device,
                                    partition_slots=ctx is not None)
            eng = Engine(cfg, params, ecfg, device=cuda_device,
                         transport=tr, mesh_ctx=ctx, **lora)
            got[(tr, str(devs))] = serve.serve(eng, requests,
                                               traffic)["tokens"]
            if tr == "fused":
                assert eng.transport_stats()["host_dispatches_per_step"] \
                    == 1.0
    want = got[("host", "None")]
    assert all(len(t) for t in want.values())
    assert all(t == want for t in got.values()), got
    # the front door: distinct cards
    pool = serve.adapter_pool(cfg, "disagg", ranks, device=cuda_device)
    kw = dict(backend="cluster", disaggregated=True, n_instances=1,
              max_batch=2, max_len=32, adapter_cache_slots=4,
              server_replicas=2, paged=True, page_size=4, n_pages=8,
              prefill_chunk=8)
    base = _served(build_system(ServeConfig(**kw), cfg, params=params,
                                pool=pool))
    assert base == _served(build_system(ServeConfig(**kw, transport="fused"),
                                        cfg, params=params, pool=pool))
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs 2 devices"):
            build_system(ServeConfig(**kw, mesh_shape=(2, 1)), cfg,
                         params=params, pool=pool)
        return
    for tr in ("host", "fused"):
        system = build_system(ServeConfig(**kw, transport=tr,
                                          mesh_shape=(2, 1)),
                              cfg, params=params, pool=pool)
        assert _served(system) == base, tr
        assert system.backend.cluster.mesh_ctx.devices == (
            cuda_device, torch.device("cuda", 1))
