"""The SPMD layer on NCCL over two cards (every test is ``gpu`` and skips
without two; ``tests/test_torch_spmd.py`` runs the same cases on gloo on
the CPU, against the JAX package):

  - the sharded ``moe_block`` on grids (1, 2) and (2, 1): the train plan
    with its gradients and the decode plan, with and without the expert
    LoRA, each through ``gmm`` and ``bgmv_expert`` on the ranks' cards
  - the kv_seq flash-decode (``decode_attention_update`` then
    ``decode_attention``) over bf16 and int8 caches, dense and as a ring

each against the local path on cuda:0 (the same kernels, one process):
within TOL of the largest magnitude, the written caches bit for bit.
Inputs are drawn with numpy from a seed; no JAX here. Run on the machine
with the cards: ``python -m pytest -q --noconftest -m gpu
tests/test_torch_spmd_card.py``."""
import numpy as np
import pytest
import torch

import torch_spmd_cases as cases
from repro_torch.configs import get_config
from repro_torch.distributed.world import spawn
from repro_torch.models import layers as tll
from repro_torch.models import moe as tmoe

TOL = 1e-5          # f32 sums in another order (cross-rank, other GEMM rows)
GRIDS = [(1, 2), (2, 1)]
NAMES = ["moe_train", "moe_train_lora", "moe_decode", "moe_decode_lora",
         "decode_bf16", "decode_int8", "decode_ring", "decode_ring_int8"]
# B x S = 16 tokens: a rank's capacity (1.25 T_l K / E, at least T_l for
# T_l <= 8 tokens a rank) then drops no pair, as the local plan's dropless
# capacity does not
B, S = 2, 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA Hopper cards (NCCL, one rank a card)")
    inp = _inputs()
    res = spawn(cases.run, 2, inp, NAMES, GRIDS, backend="nccl", timeout=60,
                join_timeout=300,
                rendezvous_dir=str(tmp_path_factory.mktemp("nccl")))
    return inp, res[0]


def _inputs():
    rng = np.random.default_rng(0)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    H, KV, hd, Sc, N, r = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16, 3, 4
    kp = np.full((Sc,), -1, np.int32)
    for p in range(5, 20):
        kp[p % Sc] = p

    def bf16(*shape):
        return torch.tensor(f32(*shape)).to(torch.bfloat16).float().numpy()

    return {
        "device": "cuda", "moe_cfg": cfg,
        "moe_params": {"router": f32(d, E, scale=0.5),
                       "gate": f32(E, d, ff, scale=0.05),
                       "up": f32(E, d, ff, scale=0.05),
                       "down": f32(E, ff, d, scale=0.05)},
        "moe_x": f32(B, S, d), "moe_dy": f32(B, S, d),
        "moe_x_dec": f32(B, 1, d),
        "moe_lora": {n: {"A": f32(N, E, din, r, scale=0.3),
                         "B": f32(N, E, r, dout, scale=0.3)}
                     for n, din, dout in (("gate", d, ff), ("up", d, ff),
                                          ("down", ff, d))},
        "moe_ids": np.array([0, 2], np.int32),
        "dec": {"q": f32(B, H, hd), "k_new": f32(B, KV, hd),
                "v_new": f32(B, KV, hd), "k_bf16": bf16(B, Sc, KV, hd),
                "v_bf16": bf16(B, Sc, KV, hd),
                "k_q8": rng.integers(-127, 128, (B, Sc, KV, hd),
                                     dtype=np.int8),
                "v_q8": rng.integers(-127, 128, (B, Sc, KV, hd),
                                     dtype=np.int8),
                "k_scale": np.abs(f32(B, Sc, KV, 1, scale=0.01)),
                "v_scale": np.abs(f32(B, Sc, KV, 1, scale=0.01)),
                "key_positions": kp, "pos": 9, "ring_pos": 20, "window": 8},
    }


def _close(got, want, what):
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


def _res(world, name, grid):
    res = world[1][(name, grid)]
    assert "error" not in res, res.get("error")
    return res


@pytest.mark.gpu
@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("name", NAMES[:4])
def test_sharded_moe_on_two_cards(world, grid, name):
    inp, dev = world[0], torch.device("cuda", 0)
    kind = "train" if "train" in name else "decode"
    lora = "lora" in name
    x = inp["moe_x"] if kind == "train" else inp["moe_x_dec"]
    tx = torch.tensor(x, device=dev, requires_grad=True)
    tp = {k: torch.tensor(v, device=dev, requires_grad=True)
          for k, v in inp["moe_params"].items()}
    tl = {n: {f: torch.tensor(a, device=dev) for f, a in ab.items()}
          for n, ab in inp["moe_lora"].items()} if lora else None
    ids = torch.tensor(np.repeat(inp["moe_ids"], x.shape[1]),
                       device=dev) if lora else None
    y = tmoe.moe_block(tx, tp, inp["moe_cfg"], kind=kind, lora=tl,
                       ids_tok=ids, lora_scale=0.5)
    res = _res(world, name, grid)
    _close(res["y"], y.detach().cpu().numpy(), "y")
    if kind == "train":
        dy = torch.tensor(inp["moe_dy"], device=dev)
        g = torch.autograd.grad((y * dy).sum(), [tx] + [
            tp[k] for k in ("router", "gate", "up", "down")])
        for k, gk in zip(("dx", "drouter", "dgate", "dup", "ddown"), g):
            _close(res[k], gk.cpu().numpy(), k)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("name", NAMES[4:])
def test_kv_seq_decode_on_two_cards(world, grid, name):
    inp, dev = world[0], torch.device("cuda", 0)
    d = inp["dec"]
    quant, ring = "int8" in name, "ring" in name
    key = "q8" if quant else "bf16"
    dt = torch.int8 if quant else torch.bfloat16

    def t(a):
        return torch.tensor(a, device=dev)

    kc, vc = t(d["k_" + key]).to(dt), t(d["v_" + key]).to(dt)
    ks = t(d["k_scale"]) if quant else None
    vs = t(d["v_scale"]) if quant else None
    kp = t(d["key_positions"]) if ring else None
    window = d["window"] if ring else 0
    pos = d["ring_pos"] if ring else d["pos"]
    slot = pos % kc.shape[1] if ring else None
    o, kc, vc, ks, vs, kp = tll.decode_attention_update(
        t(d["q"]), t(d["k_new"]), t(d["v_new"]), kc, vc, pos,
        window=window, k_scale=ks, v_scale=vs, key_positions=kp,
        write_slot=slot)
    o2 = tll.decode_attention(t(d["q"]), kc, vc, pos + 1,
                              window=window,
                              kv_scales=(ks, vs) if quant else None,
                              key_positions=kp)
    res = _res(world, name, grid)
    _close(res["out"], o.cpu().numpy(), "out")
    _close(res["read"], o2.cpu().numpy(), "read")
    np.testing.assert_array_equal(res["k"], kc.float().cpu().numpy())
    np.testing.assert_array_equal(res["v"], vc.float().cpu().numpy())
    if ring:
        np.testing.assert_array_equal(res["key_positions"], kp.cpu().numpy())
