"""The per-rank side of ``tests/test_torch_spmd.py``: what each process of
a 4-rank gloo world runs, over the grids (2, 2), (1, 4) and (4, 1) of one
``ProcessMesh`` each. No JAX here: the spawned ranks import only torch,
numpy and the port; the parent compares what rank 0 returns (whole
tensors, gathered by the ranks) against the port's local path and the
reference's.

Inputs come from the parent as numpy arrays (``inputs``); each case takes
its global tensors, cuts this rank's shards by the rules' placements,
runs the sharded function, and gathers its outputs and gradients whole.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed import steps as tsteps
from repro_torch.distributed.sharding import axes_of, use_rules
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import layers as ll
from repro_torch.models import moe as tmoe
from repro_torch.training import compression as tcomp
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_lora_train_step
from repro_torch.training.tree import flatten_with_keys, tree_map

GRIDS = [(2, 2), (1, 4), (4, 1)]


def _dev(inp):
    """The rank's device: its card under NCCL (``inp["device"] ==
    "cuda"``), else the CPU."""
    if inp.get("device") == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _t(a, dev=None):
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(
        dev or torch.device("cpu")), a)


def _np(t):
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def _whole(t, spec, mesh):
    """The global tensor from every rank's shard (int8 and bf16 moved as
    int32 and f32, which gloo takes everywhere)."""
    dt = t.dtype
    t = t.detach()
    t = t.to(torch.int32) if dt == torch.int8 else \
        t.float() if dt == torch.bfloat16 else t
    for dim, p in enumerate(spec):
        if axes_of(p):
            t = col.all_gather(t, mesh.get_group(axes_of(p)), dim)
    return t


def _cut(rules, axes, a):
    """(this rank's shard of global ``a``, its spec) by logical axes."""
    pl = rules.sharding(axes, a.shape)
    return pl.local(a).clone(), pl.spec


def _grads(loss, tensors):
    return torch.autograd.grad(loss, tensors)


# ------------------------------ the MoE ---------------------------------- #
def moe_case(mesh, inp, kind, with_lora):
    cfg, dev = inp["moe_cfg"], _dev(inp)
    p = _t(inp["moe_params"], dev)
    rules = tsteps.rules_for(mesh, kind, cfg)
    x = _t(inp["moe_x"] if kind == "train" else inp["moe_x_dec"], dev)
    B, S, _ = x.shape
    with use_rules(rules):
        plan = tmoe.resolve_moe_plan(cfg, B, S if kind != "decode" else 1,
                                     kind)
    gu, dn = tmoe.weight_specs(plan)
    xs = ("batch", "seq", None) if kind != "decode" else ("batch", None,
                                                          None)
    x_l, x_spec = _cut(rules, xs, x)
    p_l, specs = {"router": p["router"]}, {"router": (None, None)}
    for name, spec in (("gate", gu), ("up", gu), ("down", dn)):
        pl = tsteps.Placement(mesh, spec, tuple(p[name].shape))
        p_l[name], specs[name] = pl.local(p[name]).clone(), spec
    lora = ids_l = None
    if with_lora:
        lora = {n: {"A": _t(inp["moe_lora"][n]["A"], dev),
                    "B": _t(inp["moe_lora"][n]["B"], dev)}
                for n in ("gate", "up", "down")}
        ids = _t(inp["moe_ids"], dev).repeat_interleave(S)
        ids_l = _cut(rules, xs[:2], ids.reshape(B, S))[0].reshape(-1)
    out = {}
    if kind == "decode":
        with use_rules(rules), torch.no_grad():
            y = tmoe.moe_block(x_l, p_l, cfg, kind=kind, lora=lora,
                               ids_tok=ids_l, lora_scale=0.5)
        out["y"] = _np(_whole(y, x_spec, mesh))
        out["plan"] = plan
        return out
    leaves = [x_l.requires_grad_()] + [p_l[k].requires_grad_()
                                       for k in ("router", "gate", "up",
                                                 "down")]
    with use_rules(rules):
        y = tmoe.moe_block(x_l, p_l, cfg, kind=kind, lora=lora,
                           ids_tok=ids_l, lora_scale=0.5)
    dy_l = _cut(rules, xs, _t(inp["moe_dy"], dev))[0]
    g = _grads((y * dy_l).sum(), leaves)
    token_axes = tuple(a for a in mesh.axis_names
                       if a in axes_of(x_spec[0]) + axes_of(x_spec[1]))
    out["y"] = _np(_whole(y, x_spec, mesh))
    out["dx"] = _np(_whole(g[0], x_spec, mesh))
    for name, gw in zip(("router", "gate", "up", "down"), g[1:]):
        pl = tsteps.Placement(mesh, specs[name], tuple(p[name].shape))
        gw = tsteps.sum_grads(gw, pl, token_axes, mesh)
        out["d" + name] = _np(_whole(gw, specs[name], mesh))
    out["plan"] = plan
    return out


# ---------------------------- attention ---------------------------------- #
def attention_case(mesh, inp, fn):
    cfg = inp["moe_cfg"]
    rules = tsteps.rules_for(mesh, "train", cfg)
    axes = ("batch", "seq", None, None)
    q_l, spec = _cut(rules, axes, _t(inp["att_q"]))
    k_l, _ = _cut(rules, axes, _t(inp["att_k"]))
    v_l, _ = _cut(rules, axes, _t(inp["att_v"]))
    out = {}
    if fn == "causal":
        with use_rules(rules):
            o = ll.causal_attention(q_l, k_l, v_l, causal=True)
        out["out"] = _np(_whole(o, spec, mesh))
        return out
    for t in (q_l, k_l, v_l):
        t.requires_grad_()
    with use_rules(rules):
        o = ll.flash_attention(q_l, k_l, v_l, causal=True, q_chunk=4)
    do_l = _cut(rules, axes, _t(inp["att_do"]))[0]
    dq, dk, dv = _grads((o * do_l).sum(), [q_l, k_l, v_l])
    for name, t in (("out", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        out[name] = _np(_whole(t, spec, mesh))
    return out


# ------------------------------ the MLP ---------------------------------- #
def mlp_case(mesh, inp):
    cfg = inp["mlp_cfg"]
    rules = tsteps.rules_for(mesh, "train", cfg)
    x_l, x_spec = _cut(rules, ("batch", "seq", None), _t(inp["mlp_x"]))
    p = _t(inp["mlp_params"])
    B, S = inp["mlp_x"].shape[:2]
    spec_of = {"gate": ("fsdp", "mlp"), "up": ("fsdp", "mlp"),
               "down": ("mlp", "fsdp")}
    p_l, pl = {}, {}
    for k, v in p.items():
        pl[k] = rules.sharding(spec_of[k], tuple(v.shape))
        p_l[k] = pl[k].local(v).clone().requires_grad_()
    x_l.requires_grad_()
    with use_rules(rules):
        sp = ll.mlp_sp_axes(rules, cfg, x_l.shape[0], x_l.shape[1])
        y = ll.mlp(x_l, p_l, cfg)
    dy_l = _cut(rules, ("batch", "seq", None), _t(inp["mlp_dy"]))[0]
    keys = sorted(p_l)
    g = _grads((y * dy_l).sum(), [x_l] + [p_l[k] for k in keys])
    token_axes = tuple(a for a in mesh.axis_names
                       if a in axes_of(x_spec[0]) + axes_of(x_spec[1]))
    out = {"y": _np(_whole(y, x_spec, mesh)),
           "dx": _np(_whole(g[0], x_spec, mesh)), "sp": sp is not None}
    for k, gw in zip(keys, g[1:]):
        gw = tsteps.sum_grads(gw, pl[k], token_axes, mesh)
        out["d" + k] = _np(_whole(gw, pl[k].spec, mesh))
    return out


# ------------------------- kv_seq flash-decode --------------------------- #
def decode_case(mesh, inp, quant, ring):
    cfg, dev = inp["moe_cfg"], _dev(inp)
    rules = tsteps.rules_for(mesh, "decode", cfg)
    d = inp["dec"]
    tok = ("batch", None, None)
    q_l, q_spec = _cut(rules, tok, _t(d["q"], dev))
    kn_l, _ = _cut(rules, tok, _t(d["k_new"], dev))
    vn_l, _ = _cut(rules, tok, _t(d["v_new"], dev))
    cax = ("batch", "kv_seq", "kv_heads", None)
    key = "q8" if quant else "bf16"
    dt = torch.int8 if quant else torch.bfloat16    # bf16 values sent as f32
    kc_l, c_spec = _cut(rules, cax, _t(d["k_" + key], dev).to(dt))
    vc_l, _ = _cut(rules, cax, _t(d["v_" + key], dev).to(dt))
    ks_l = vs_l = None
    if quant:
        ks_l, s_spec = _cut(rules, cax, _t(d["k_scale"], dev))
        vs_l, _ = _cut(rules, cax, _t(d["v_scale"], dev))
    kp_l = kp_spec = None
    if ring:
        kp_l, kp_spec = _cut(rules, ("kv_seq",), _t(d["key_positions"], dev))
    pos = d["ring_pos"] if ring else d["pos"]
    window = d["window"] if ring else 0
    slot = pos % d["k_bf16"].shape[1] if ring else None
    with use_rules(rules):
        o, kc, vc, ks, vs, kp = ll.decode_attention_update(
            q_l, kn_l, vn_l, kc_l, vc_l, pos, window=window, k_scale=ks_l,
            v_scale=vs_l, key_positions=kp_l, write_slot=slot)
        o2 = ll.decode_attention(
            q_l, kc, vc, pos + 1, window=window,
            kv_scales=(ks, vs) if quant else None, key_positions=kp)
    out = {"out": _np(_whole(o, q_spec, mesh)),
           "read": _np(_whole(o2, q_spec, mesh)),
           "k": _np(_whole(kc, c_spec, mesh)),
           "v": _np(_whole(vc, c_spec, mesh))}
    if quant:
        out["k_scale"] = _np(_whole(ks, s_spec, mesh))
        out["v_scale"] = _np(_whole(vs, s_spec, mesh))
    if ring:
        out["key_positions"] = _np(_whole(kp, kp_spec, mesh))
    return out


# ----------------------------- the steps --------------------------------- #
def train_step_case(mesh, inp, which):
    cfg, params = inp[which + "_cfg"], _t(inp[which + "_model"])
    batch = {k: _t(v) for k, v in inp["step_batch"].items()}
    B, S = batch["tokens"].shape
    shape = inp["train_shape"]
    step, abstract, rules = tsteps.jit_train_step(
        cfg, shape, mesh, topt.AdamWConfig(**inp["opt"]))
    place = tsteps.step_placements(cfg, rules)
    p_l = tree_map(lambda t: t.clone(), tsteps.local_params(params, place))
    o_l = topt.init(p_l)
    b_l = {k: tsteps.Placement(mesh, rules.spec(("batch", "seq"), (B, S)),
                               (B, S)).local(v).clone()
           for k, v in batch.items()}
    loss, p_new, _ = step(p_l, o_l, b_l)
    whole = tsteps.whole_params(p_new, place)
    return {"loss": float(loss),
            "params": {k: _np(v) for k, v in flatten_with_keys(whole).items()},
            "abstract_embed": tuple(abstract[0]["embed"].shape)}


def prefill_step_case(mesh, inp, which):
    cfg, params = inp[which + "_cfg"], _t(inp[which + "_model"])
    toks = _t(inp["step_batch"]["tokens"])
    B, S = toks.shape
    step, _, rules = tsteps.jit_prefill_step(cfg, inp["prefill_shape"],
                                             mesh)
    place = tsteps.step_placements(cfg, rules)
    spec = rules.spec(("batch", "seq"), (B, S))
    t_l = tsteps.Placement(mesh, spec, (B, S)).local(toks).clone()
    logits = step(tsteps.local_params(params, place), {"tokens": t_l})
    return {"logits": _np(_whole(logits, spec + (None,), mesh))}


def serve_step_case(mesh, inp, which):
    from repro_torch.models.cache import init_cache
    cfg, params = inp[which + "_cfg"], _t(inp[which + "_model"])
    shape = inp["serve_shape"]
    B, S = shape.global_batch, shape.seq_len
    step, (_, cache_abs, _), rules = tsteps.jit_serve_step(cfg, shape, mesh)
    _, placements = tsteps.cache_specs(cfg, shape, rules)
    place = tsteps.step_placements(cfg, rules)
    cache = init_cache(cfg, B, S, device="cpu", dtype=torch.float32)
    cache = {k: placements[k].local(v).clone() if torch.is_tensor(v) else v
             for k, v in cache.items()}
    p_l = tsteps.local_params(params, place)
    tok_spec = rules.spec(("batch", None), (B, 1))
    logits = []
    for t in inp["serve_tokens"]:
        t_l = tsteps.Placement(mesh, tok_spec, (B, 1)).local(
            torch.from_numpy(t)).clone()
        lg, cache = step(p_l, cache, {"tokens": t_l})
        logits.append(_np(_whole(lg, tok_spec, mesh)))
    out = {"logits": np.stack(logits)}
    if "k" in cache:            # the attention families' KV (not a ring's)
        out["cache_k"] = _np(_whole(cache["k"], placements["k"].spec, mesh))
    return out


def lora_dp_case(mesh, inp, compress):
    """Data-parallel fine-tune over the (4, 1) grid's "data" axis: each
    rank its row of the global batch; two steps, one compressed."""
    d = inp["lora_dp"]
    cfg = inp["mlp_cfg"]
    step = make_lora_train_step(cfg, _t(d["params"]), d["scale"],
                                topt.AdamWConfig(**d["opt"]),
                                compress=compress, axis_name="data",
                                mesh=mesh)
    adapter = _t(d["adapter"])
    opt = topt.init(adapter)
    err = tcomp.init_error(adapter)
    r = mesh.coord("data")
    losses = []
    for toks, labels in d["batches"][:1 if compress else None]:
        b = {"tokens": torch.from_numpy(toks[r:r + 1]),
             "labels": torch.from_numpy(labels[r:r + 1])}
        loss, adapter, opt, err = step(adapter, opt, err, b)
        losses.append(float(loss))
    return {"losses": losses,
            "adapter": {k: _np(v) for k, v in
                        flatten_with_keys(adapter).items()},
            "err": {k: _np(v) for k, v in flatten_with_keys(err).items()}}


def _cases(grid):
    out = {
        "moe_train": lambda m, i: moe_case(m, i, "train", False),
        "moe_train_lora": lambda m, i: moe_case(m, i, "train", True),
        "moe_decode": lambda m, i: moe_case(m, i, "decode", False),
        "moe_decode_lora": lambda m, i: moe_case(m, i, "decode", True),
        "flash_attention": lambda m, i: attention_case(m, i, "flash"),
        "causal_attention": lambda m, i: attention_case(m, i, "causal"),
        "mlp": mlp_case,
        "decode_bf16": lambda m, i: decode_case(m, i, False, False),
        "decode_int8": lambda m, i: decode_case(m, i, True, False),
        "decode_ring": lambda m, i: decode_case(m, i, False, True),
        "decode_ring_int8": lambda m, i: decode_case(m, i, True, True),
    }
    for which in ("moe", "mlp"):
        out[f"train_step_{which}"] = \
            lambda m, i, w=which: train_step_case(m, i, w)
        out[f"prefill_step_{which}"] = \
            lambda m, i, w=which: prefill_step_case(m, i, w)
        out[f"serve_step_{which}"] = \
            lambda m, i, w=which: serve_step_case(m, i, w)
    if grid == (4, 1):
        out["lora_dp"] = lambda m, i: lora_dp_case(m, i, False)
        out["lora_dp_compressed"] = lambda m, i: lora_dp_case(m, i, True)
    return out


def run(rank, world, inp, names=None, grids=None):
    """Every case (or those in ``names``) on every grid (or ``grids``);
    {(case, grid): result} from rank 0 (the others return their DP
    losses only). A failing case is reported as its traceback, so the
    other cases still run."""
    import traceback
    out = {}
    try:                        # a mesh that needs another world
        make_debug_mesh(2, 4)
        out["mesh_refusal"] = None
    except ValueError as e:
        out["mesh_refusal"] = str(e)
    for grid in grids or GRIDS:
        mesh = make_debug_mesh(*grid)
        for name, fn in _cases(grid).items():
            if names is not None and name not in names:
                continue
            try:
                res = fn(mesh, inp)
            except Exception:   # reported to the parent as that case's
                res = {"error": traceback.format_exc()}
            if rank == 0 or name.startswith("lora_dp"):
                out[(name, grid)] = res
    return out
