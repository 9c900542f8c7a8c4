"""The training plane's kernel gradients on the card (every test is ``gpu``
and skips without one; the CPU tests of the plane, against the JAX
package, are ``tests/test_torch_training.py`` and
``tests/test_torch_train_grads.py``):

  - ``ops.bgmv``, ``ops.bgmv_expert`` (also with the true-rank mask) and
    ``ops.gmm`` under autograd: the forward and dx through the
    hand-written kernels (their launch counts move: forward + dx for the
    two LoRA kernels, forward only for ``gmm``, whose backward is
    ``torch.bmm``), each gradient within TOL of torch autograd of the
    plain twin on the same card (TOL; a bf16 gradient BF16_TOL), for the
    fine-tune's operand types (bf16 activations, f32 adapter factors;
    bf16 expert weights)
  - a LoRA fine-tune step of reduced qwen3-moe (f32 base, 2048 tokens)
    on the card launches all three kernels; its loss is within 1e-5 of
    the same step with the plain twins in place of the kernels (torch
    autograd of the twins), each adapter gradient within 1e-3 of the
    leaf's largest magnitude. (With a bf16 base the two sum orders flip
    single bf16 roundings of the activations, and an element of a
    gradient moves by a few percent; the full-width step of
    ``chip_smoke.py`` phase 12(ii) holds the gradients' norms there.)

Weights are drawn with torch from a seed (no JAX here)."""
import pytest
import torch

from repro_torch.kernels import bgmv, gmm, ops, ref

TOL = 1e-4      # f32 sums in another order; bf16 inputs, f32 factors
BF16_TOL = 2 ** -7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _leaves(dev, g, *specs):
    """Leaves requiring gradients, drawn on the CPU from ``g``: (shape,
    dtype, scale) each."""
    return [(torch.randn(shape, generator=g) * scale).to(dtype).to(dev)
            .requires_grad_() for shape, dtype, scale in specs]


def _grads_close(got, want, what):
    """Each within TOL of the twin's largest magnitude; a bf16 one (dx of
    bf16 activations) within BF16_TOL: both round one f32 sum to bf16,
    and two sum orders put a few values on either side of a rounding."""
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        tol = BF16_TOL if a.dtype == torch.bfloat16 else TOL
        assert err <= tol * b.float().abs().max().item(), (what, err)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bgmv", "bgmv_expert", "bgmv_expert_ranked",
                                  "gmm"])
def test_kernel_autograd_matches_twin_on_card(cuda_device, case):
    dev = cuda_device
    g = torch.Generator().manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    T, d_in, r, d_out, N, E = 512, 1024, 8, 768, 2, 8
    ids = torch.randint(-1, N, (T,), generator=g, dtype=torch.int32).to(dev)
    eids = torch.randint(0, E, (T,), generator=g, dtype=torch.int32).to(dev)
    if case == "bgmv":
        leaves = _leaves(dev, g, ((T, d_in), bf16, 1.0),
                         ((N, d_in, r), f32, 0.1), ((N, r, d_out), f32, 0.1))
        kernel, counter = (lambda x, A, B: ops.bgmv(x, A, B, ids)), bgmv.bgmv
        twin = lambda x, A, B: ref.bgmv_ref(x, A, B, ids)   # noqa: E731
    elif case.startswith("bgmv_expert"):
        leaves = _leaves(dev, g, ((T, d_in), bf16, 1.0),
                         ((N, E, d_in, r), f32, 0.1),
                         ((N, E, r, d_out), f32, 0.1))
        extra = ()
        if case.endswith("ranked"):
            extra = (torch.randint(1, r // 2 + 1, (T,), generator=g,
                                   dtype=torch.int32).to(dev), r // 2)
        kernel = lambda x, A, B: ops.bgmv_expert(     # noqa: E731
            x, A, B, ids, eids, *extra)
        twin = lambda x, A, B: ref.bgmv_expert_ref(   # noqa: E731
            x, A, B, ids, eids, *extra)
        counter = bgmv.bgmv_expert
    else:
        C, d, f = 96, 512, 384
        leaves = _leaves(dev, g, ((E, C, d), bf16, 1.0),
                         ((E, d, f), bf16, 0.05))
        sizes = torch.randint(0, C + 1, (E,), generator=g,
                              dtype=torch.int32).to(dev)
        kernel = lambda xe, w: ops.gmm(xe, w, sizes)   # noqa: E731
        twin = lambda xe, w: ref.gmm_ref(xe, w, sizes)  # noqa: E731
        counter = gmm.gmm
    before = counter.launches
    y = kernel(*leaves)
    dy = torch.randn(y.shape, generator=g).to(dev)
    got = torch.autograd.grad(y, leaves, dy)
    launched = counter.launches - before
    twin_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    y2 = twin(*twin_leaves)
    want = torch.autograd.grad(y2, twin_leaves, dy)
    torch.cuda.synchronize()
    _grads_close([y], [y2], case + " forward")
    # gmm's gradients are bf16 products of the bf16-rounded dy, the
    # twin's autograd takes them in f32: within bf16 rounding
    _grads_close(got, want, case)
    assert [t.dtype for t in got] == [t.dtype for t in leaves]
    assert launched == (1 if case == "gmm" else 2), launched


@pytest.mark.gpu
def test_lora_step_kernels_match_twins_on_card(cuda_device, monkeypatch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.adapter import init_adapter_pool
    from repro_torch.models.model import init_params
    from repro_torch.training import data as tdata
    from repro_torch.training.train_step import make_lora_loss, \
        value_and_grad
    from repro_torch.training.tree import flatten_with_keys
    dev = cuda_device
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              n_layers=2)
    params = init_params(cfg, seed=0, dtype="float32", device=dev)
    pool = init_adapter_pool(cfg, 1, seed=1, rank=8, dtype=torch.float32,
                             device=dev)
    toks, labels = tdata.batch_at(tdata.DataConfig(cfg.vocab_size, 512, 4),
                                  0)
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}
    loss_fn = make_lora_loss(cfg, params, pool.scale)
    counts = (bgmv.bgmv.launches, bgmv.bgmv_expert.launches, gmm.gmm.launches)
    loss, grads = value_and_grad(loss_fn, pool.tensors, batch)
    torch.cuda.synchronize()
    moved = [c.launches - n for c, n in zip(
        (bgmv.bgmv, bgmv.bgmv_expert, gmm.gmm), counts)]
    assert all(m > 0 for m in moved), moved
    # the same step through the plain twins, differentiated by autograd
    monkeypatch.setattr(ops, "bgmv", ref.bgmv_ref)
    monkeypatch.setattr(ops, "bgmv_expert", ref.bgmv_expert_ref)
    monkeypatch.setattr(ops, "gmm", ref.gmm_ref)
    loss2, grads2 = value_and_grad(loss_fn, pool.tensors, batch)
    assert abs(loss.item() - loss2.item()) <= 1e-5 * abs(loss2.item())
    a, b = flatten_with_keys(grads), flatten_with_keys(grads2)
    for k in a:
        err = (a[k] - b[k]).abs().max().item()
        assert err <= 1e-3 * b[k].abs().max().item(), (k, err)
