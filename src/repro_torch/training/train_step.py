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

The reference's data-parallel branch (``axis_name``: a pmean of the
gradients, or an int8 psum / pmax with error feedback) is a collective of
the SPMD steps, ROADMAP A8b: asking for it raises."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.steps import lm_loss
from repro_torch.models import transformer
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


def make_lora_train_step(cfg, base_params, scale: float,
                         opt_cfg: opt_mod.AdamWConfig,
                         compress: bool = False, axis_name: str = None):
    """Returns step(adapter, opt_state, err, batch) -> (loss, adapter,
    opt_state, err): one AdamW step of the adapter. ``batch``: {"tokens",
    "labels"} (B, S) int tensors on the parameters' device."""
    if axis_name is not None:
        raise NotImplementedError(
            "make_lora_train_step(axis_name=...): the data-parallel gradient "
            "all-reduce (pmean, or int8 psum/pmax with compression) needs a "
            "process group, which comes with the SPMD steps (ROADMAP A8b)")
    loss_fn = make_lora_loss(cfg, base_params, scale)

    def step(adapter, opt_state, err, batch):
        loss, grads = value_and_grad(loss_fn, adapter, batch)
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
