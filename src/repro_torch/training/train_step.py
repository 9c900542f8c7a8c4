"""LoRA fine-tuning: train per-tenant adapters against a frozen base
model, the counterpart of ``repro.training.train_step``. This is the
substrate that produces the adapters the serving system hosts.

``make_lora_train_step`` differentiates only the adapter tensors: the
base parameters do not require gradients, and the adapter is a tree of
leaves {target: {"A": (L, 1, ...), "B": (L, 1, ...)}}. Through the
model's coupled LoRA path the gradients flow through ``ops.bgmv`` (the
attention and dense-MLP targets) and ``ops.bgmv_expert`` (the expert
hooks), and the activations' through ``ops.gmm`` (the base expert GEMMs):
the hand-written kernels on the card (``kernels.autograd``).

With ``axis_name`` the step is the reference's data-parallel one: each
process of that axis of a ``ProcessMesh`` takes its share of the batch,
and the adapter's gradients are averaged over the axis (an all-reduce
sum over its process group, divided by its size) or, with ``compress``,
quantized to int8 with error feedback (``training.compression``), the
codes summed as int32 and the scales maxed over the axis, and the summed
codes times the max scale taken as the gradient: the reference's formula,
which does not divide by the number of processes."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed import collectives as col
from repro_torch.models import transformer
from repro_torch.training import compression
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.tree import flatten_with_keys, tree_map, \
    unflatten_like


def single_adapter_ctx(adapter_tensors: Dict, batch_size: int,
                       scale: float):
    """lora_ctx selecting adapter 0 for every sequence (the fine-tune's
    view). adapter_tensors: {target: {"A": (L, 1, ...), "B": (L, 1, ...)}}."""
    dev = next(iter(adapter_tensors.values()))["A"].device
    return {"adapters": adapter_tensors,
            "ids": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            "scale": scale}


def _nll_sum(logits, labels):
    """The f32 cross-entropy summed over the positions whose label is not
    negative."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return ((lse - tgt) * (labels >= 0)).sum()


def lm_loss(logits, labels):
    """Masked next-token cross-entropy in f32: labels < 0 take no part;
    the mean over the labelled positions (at least one)."""
    return _nll_sum(logits, labels) / (labels >= 0).sum().clamp_min(1)


def value_and_grad(fn, tree, *args):
    """(fn(tree, *args), d fn / d tree) for a scalar ``fn`` of a tree of
    tensors: the leaves are taken as new leaves that require gradients,
    so nothing else of the caller's graph is differentiated."""
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(True), tree)
        loss = fn(live, *args)
        flat = flatten_with_keys(live)
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True)
    # a leaf the loss does not reach has a zero gradient
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat.values(), grads)]
    return loss.detach(), unflatten_like(tree, dict(zip(flat, grads)))


def make_lora_loss(cfg, base_params, scale: float):
    """loss(adapter, batch): the LM loss of the base model with the
    adapter applied to every sequence, on ``forward(kind="train")``."""
    def loss_fn(adapter, batch):
        B = batch["tokens"].shape[0]
        ctx = single_adapter_ctx(adapter, B, scale)
        logits, _ = transformer.forward(base_params, cfg, batch["tokens"],
                                        kind="train", lora_ctx=ctx)
        return lm_loss(logits, batch["labels"])

    return loss_fn


def host_tensors(adapter: Dict, targets=None) -> Dict[str, torch.Tensor]:
    """A trained adapter {target: {"A": (L, 1, ...), "B": ...}} in the
    serving plane's canonical host format ({"<target>.A": (L, [E,] d_in,
    r)}, CPU tensors, ``ServeSystem.load_adapter``'s input), restricted to
    ``targets`` when given (the disaggregated plane takes the expert FFN's
    only)."""
    return {f"{t}.{f}": ab[f][:, 0].detach().cpu().contiguous()
            for t, ab in adapter.items() if targets is None or t in targets
            for f in ("A", "B")}


def axis_group(axis_name: str, mesh=None):
    """(process group, size) of axis ``axis_name`` of ``mesh`` (a
    ``launch.mesh.ProcessMesh``); a RuntimeError names the missing process
    group where there is none."""
    if mesh is None or not hasattr(mesh, "get_group") or \
            axis_name not in mesh.axis_names:
        raise RuntimeError(
            f"no process group for axis_name {axis_name!r}: the data-parallel "
            f"step all-reduces its gradients over that axis of a ProcessMesh "
            f"(launch.mesh.make_process_mesh over an initialised "
            f"torch.distributed world), given as mesh=")
    return mesh.get_group(axis_name), mesh.size(axis_name)


def _all_reduce_grads(grads, err, group, n: int, compress: bool):
    """The reference's data-parallel gradient: pmean, or the int8 codes'
    int32 psum times the scales' pmax (``compress``; err carried)."""
    if not compress:
        return tree_map(lambda g: col.all_reduce(g, group) / n, grads), err
    q, err = compression.compress_tree(grads, err)
    grads = tree_map(
        lambda t: col.all_reduce(t[0].to(torch.int32), group).to(
            torch.float32) * col.all_reduce(t[1], group, op="max"),
        q, is_leaf=lambda t: isinstance(t, tuple))
    return grads, err


def make_lora_train_step(cfg, base_params, scale: float,
                         opt_cfg: opt_mod.AdamWConfig,
                         compress: bool = False, axis_name: str = None,
                         mesh=None):
    """Returns step(adapter, opt_state, err, batch) -> (loss, adapter,
    opt_state, err): one AdamW step of the adapter. ``batch``: {"tokens",
    "labels"} (B, S) int tensors on the parameters' device (this process's
    share under ``axis_name``; ``err`` the compression's residual tree,
    ``compression.init_error``, with ``compress``). ``axis_name`` needs
    its process group (``axis_group``): building the step raises without
    one."""
    group = n = None
    if axis_name is not None:
        group, n = axis_group(axis_name, mesh)
    loss_fn = make_lora_loss(cfg, base_params, scale)

    def step(adapter, opt_state, err, batch):
        loss, grads = value_and_grad(loss_fn, adapter, batch)
        if axis_name is not None:
            grads, err = _all_reduce_grads(grads, err, group, n, compress)
        adapter, opt_state = opt_mod.update(adapter, grads, opt_state,
                                            opt_cfg)
        return loss, adapter, opt_state, err

    return step


def make_train_step(cfg, opt_cfg: opt_mod.AdamWConfig):
    """Full-parameter training on one device: step(params, opt_state,
    batch) -> (loss, params, opt_state)."""
    def loss_fn(params, batch):
        logits, _ = transformer.forward(params, cfg, batch["tokens"],
                                        kind="train")
        return lm_loss(logits, batch["labels"])

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = opt_mod.update(params, grads, opt_state, opt_cfg)
        return loss, params, opt_state

    return step
