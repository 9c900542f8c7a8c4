"""Gradients of the port's training plane against the JAX reference, on the
CPU in f32 at the reference's reduced configs:

  - ``layers.flash_attention``'s output and dq, dk, dv against ``jax.vjp``
    of ``repro.models.layers.causal_attention`` (its custom VJP): causal,
    a window, a q_offset, GQA and several chunks, within 1e-5
  - the autograd Functions of ``ops.bgmv``, ``ops.bgmv_expert`` (also
    with the serving hook's true-rank mask) and ``ops.gmm`` (group
    sizes, bf16 weights): their explicit backward, which runs through the
    plain twins here, against ``jax.vjp`` of the reference's oracles
    (``repro.core.lora_math``, ``repro.kernels.ref.gmm_ref``) and against
    torch autograd of the twin, within 1e-5; ``out=`` is refused under
    autograd, and no gradient means no Function
  - ``forward(kind="train")``: logits and every parameter's gradient
    against ``jax.value_and_grad`` of the reference's masked LM loss for
    reduced smollm, qwen3-moe (also at T*K > 4096, so the capacity plan
    drops overflow), rwkv6, zamba2 and seamless, within 1e-4 relative to
    the largest magnitude of each leaf; its logits equal the prefill
    forward's

seamless's encoder runs in bf16 whatever the weights (the reference casts
its frames to bf16), so: the reference is compiled without XLA's excess
precision (each bf16 op rounds, as the port's do), and the gradients of
the encoder's weights (and of the cross attention's k/v projections,
which reach it) are held at 2e-2 relative: they are sums of bf16-rounded
terms, accumulated in another order by each package (2^-8 a rounding).

Weights are numpy draws (``test_torch_static.draw_params``); the JAX
value-and-grad of each config is jitted once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import lora_math as jlm
from repro.distributed.steps import lm_loss as jlm_loss
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import bridge
from repro_torch.distributed.steps import lm_loss
from repro_torch.kernels import autograd as tag
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.training.tree import flatten_with_keys, tree_map
from test_torch_static import draw_params

ATTN_TOL = 1e-5
KERNEL_TOL = 1e-5
REL_TOL = 1e-4
BF16_REL_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


# ------------------------------ attention ------------------------------- #
ATTN_CASES = {
    # name: (B, Sq, Sk, H, KV, hd, causal, window, q_offset, q_chunk)
    "causal_chunks": (2, 64, 64, 4, 4, 16, True, 0, 0, 16),
    "gqa_window": (2, 48, 48, 6, 2, 8, True, 10, 0, 16),
    "q_offset": (1, 32, 80, 4, 2, 16, True, 0, 48, 8),
    "q_offset_window": (1, 32, 80, 4, 1, 16, True, 20, 48, 16),
    "bidirectional": (2, 24, 40, 4, 2, 8, False, 0, 0, 8),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_matches_reference_vjp(case):
    B, Sq, Sk, H, KV, hd, causal, window, q_off, q_chunk = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = _rand(rng, B, Sq, H, hd), _rand(rng, B, Sk, KV, hd), \
        _rand(rng, B, Sk, KV, hd)
    dout = _rand(rng, B, Sq, H, hd)

    def jf(q, k, v):
        return jlayers.causal_attention(q, k, v, causal=causal,
                                        window=window, q_chunk=q_chunk,
                                        q_offset=q_off)

    want, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wq, wk, wv = vjp(jnp.asarray(dout))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    got = tlayers.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  q_chunk=q_chunk, q_offset=q_off)
    got.backward(_t(dout))
    assert Sq // q_chunk > 1 or case == "bidirectional"
    for a, b in ((want, got), (wq, tq.grad), (wk, tk.grad), (wv, tv.grad)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=ATTN_TOL, rtol=0)
    # and the prefill's attention on the same inputs
    np.testing.assert_allclose(
        tlayers.causal_attention(tq.detach(), tk.detach(), tv.detach(),
                                 causal=causal, window=window,
                                 q_offset=q_off).numpy(),
        got.detach().numpy(), atol=ATTN_TOL, rtol=0)


# --------------------------- kernel autograd ---------------------------- #
def _kernel_case(name, rng):
    """(numpy inputs, the port's op, the reference's jnp oracle, the plain
    twin), each a function of the differentiated inputs."""
    T, d_in, r, d_out, N, E = 24, 32, 8, 48, 3, 4
    if name == "bgmv":
        x, A, B = _rand(rng, T, d_in), _rand(rng, N, d_in, r, scale=0.3), \
            _rand(rng, N, r, d_out, scale=0.3)
        ids = rng.integers(-1, N, T).astype(np.int32)
        return ((x, A, B), lambda x, A, B: ops.bgmv(x, A, B, _t(ids)),
                lambda x, A, B: jlm.bgmv(x, A, B, jnp.asarray(ids)),
                lambda x, A, B: tref.bgmv_ref(x, A, B, _t(ids)))
    if name in ("bgmv_expert", "bgmv_expert_ranked"):
        x, A, B = _rand(rng, T, d_in), _rand(rng, N, E, d_in, r, scale=0.3), \
            _rand(rng, N, E, r, d_out, scale=0.3)
        ids = rng.integers(-1, N, T).astype(np.int32)
        eids = rng.integers(0, E, T).astype(np.int32)
        if name == "bgmv_expert":
            return ((x, A, B),
                    lambda x, A, B: ops.bgmv_expert(x, A, B, _t(ids),
                                                    _t(eids)),
                    lambda x, A, B: jlm.bgmv_expert(x, A, B, jnp.asarray(ids),
                                                    jnp.asarray(eids)),
                    lambda x, A, B: tref.bgmv_expert_ref(x, A, B, _t(ids),
                                                         _t(eids)))
        ranks = rng.integers(1, r // 2 + 1, T).astype(np.int32)
        r_mod = r // 2    # the fused gate|up hook's two blocks

        def oracle(x, A, B):
            sel = (jnp.maximum(jnp.asarray(ids), 0), jnp.asarray(eids))
            h = jnp.einsum("td,tdr->tr", x, A[sel])
            keep = (jnp.arange(r)[None, :] % r_mod) < jnp.asarray(
                ranks)[:, None]
            y = jnp.einsum("tr,tro->to", jnp.where(keep, h, 0.0), B[sel])
            return jnp.where((jnp.asarray(ids) >= 0)[:, None], y, 0.0)

        return ((x, A, B),
                lambda x, A, B: ops.bgmv_expert(x, A, B, _t(ids), _t(eids),
                                                _t(ranks), r_mod),
                oracle,
                lambda x, A, B: tref.bgmv_expert_ref(x, A, B, _t(ids),
                                                     _t(eids), _t(ranks),
                                                     r_mod))
    C, d, f = 6, 16, 24
    xe, w = _rand(rng, E, C, d), _rand(rng, E, d, f, scale=0.3)
    gs = np.array([6, 0, 3, 5], np.int32)
    return ((xe, w), lambda xe, w: ops.gmm(xe, w, _t(gs)),
            lambda xe, w: jref.gmm_ref(xe, w, jnp.asarray(gs)),
            lambda xe, w: tref.gmm_ref(xe, w, _t(gs)))


@pytest.mark.parametrize("name", ["bgmv", "bgmv_expert", "bgmv_expert_ranked",
                                  "gmm"])
def test_kernel_backward_matches_reference_vjp_and_twin(name):
    rng = np.random.default_rng(7)
    inputs, port, oracle, twin = _kernel_case(name, rng)
    want, vjp = jax.vjp(oracle, *map(jnp.asarray, inputs))
    dy = _rand(rng, *want.shape)
    wgrads = vjp(jnp.asarray(dy))
    leaves = [_t(a, True) for a in inputs]
    got = port(*leaves)
    assert got.grad_fn is not None and type(got.grad_fn).__name__ in (
        "BgmvFnBackward", "BgmvExpertFnBackward", "GmmFnBackward")
    got.backward(_t(dy))
    tw_leaves = [_t(a, True) for a in inputs]
    twin(*tw_leaves).backward(_t(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=0)
    for leaf, tw, wg in zip(leaves, tw_leaves, wgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wg),
                                   atol=KERNEL_TOL, rtol=0)
        np.testing.assert_allclose(leaf.grad.numpy(), tw.grad.numpy(),
                                   atol=KERNEL_TOL, rtol=0)


def test_gmm_backward_bf16_weights():
    """A bf16 weight takes its products in bf16: dx within bf16 rounding of
    the f32 twin's, in the operand's dtype; dw likewise."""
    rng = np.random.default_rng(3)
    xe = torch.tensor(_rand(rng, 4, 8, 16)).to(torch.bfloat16)
    w = torch.tensor(_rand(rng, 4, 16, 32, scale=0.3)).to(torch.bfloat16)
    gs = torch.tensor([8, 2, 0, 5], dtype=torch.int32)
    dy = torch.tensor(_rand(rng, 4, 8, 32))
    a, b = xe.clone().requires_grad_(), w.clone().requires_grad_()
    ops.gmm(a, b, gs).backward(dy)
    a2, b2 = xe.float().requires_grad_(), w.float().requires_grad_()
    tref.gmm_ref(a2, b2, gs).backward(dy)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    for g, want in ((a.grad, a2.grad), (b.grad, b2.grad)):
        err = (g.float() - want).abs().max() / want.abs().max()
        assert err < 2e-2
    assert torch.all(a.grad[1, 2:] == 0) and torch.all(a.grad[2] == 0)


def test_autograd_routing():
    """No operand requiring a gradient: the plain call, no Function; an
    ``out=`` under autograd is refused."""
    rng = np.random.default_rng(0)
    x, A, B = _t(_rand(rng, 4, 8)), _t(_rand(rng, 2, 8, 4)), \
        _t(_rand(rng, 2, 4, 8))
    ids = torch.tensor([0, 1, -1, 0], dtype=torch.int32)
    assert not tag.needs_grad(x, A, B)
    assert ops.bgmv(x, A, B, ids).grad_fn is None
    A.requires_grad_()
    with torch.no_grad():
        assert ops.bgmv(x, A, B, ids).grad_fn is None
    assert ops.bgmv(x, A, B, ids).grad_fn is not None
    xe, w = _t(_rand(rng, 2, 4, 8), True), _t(_rand(rng, 2, 8, 8))
    with pytest.raises(ValueError, match="out="):
        ops.gmm(xe, w, out=torch.empty(2, 4, 8))
    Ae = _t(_rand(rng, 2, 3, 8, 4), True)
    Be = _t(_rand(rng, 2, 3, 4, 8))
    with pytest.raises(ValueError, match="out="):
        ops.bgmv_expert(x, Ae, Be, ids, ids.clamp_min(0),
                        out=torch.empty(4, 8))


# ------------------------ forward(kind="train") ------------------------- #
# arch -> (batch, seq); qwen3-moe's second case has T*K = 6144 > 4096
TRAIN_CASES = {
    "smollm-360m": (2, 48),
    "qwen3-moe-235b-a22b": (2, 32),
    "qwen3-moe-235b-a22b-capacity": (3, 1024),
    "rwkv6-3b": (2, 64),
    "zamba2-2.7b": (2, 64),
    "seamless-m4t-large-v2": (2, 32),
}
FRONTEND_FRAMES = 16


def _bf16_encoder_leaf(key: str) -> bool:
    return key.startswith("['enc_") or key in (
        "['layers']['cross']['wk']", "['layers']['cross']['wv']")


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_forward_grads_match_reference(case):
    arch = case.replace("-capacity", "")
    B, S = TRAIN_CASES[case]
    jcfg = get_config(arch).reduced()
    params = draw_params(jcfg, 0)
    tcfg = bridge.config_from(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    fe = (_rand(rng, B, FRONTEND_FRAMES, jcfg.d_model, scale=0.1)
          if jcfg.frontend else None)
    if arch.startswith("qwen3"):
        assert (B * S * jcfg.top_k > 4096) == case.endswith("capacity")

    def jloss(p):
        logits, _ = jtransformer.forward(
            p, jcfg, jnp.asarray(toks),
            frontend_emb=None if fe is None else jnp.asarray(fe),
            kind="train")
        return jlm_loss(logits, jnp.asarray(labels)), logits

    fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    if jcfg.family == "audio":
        fn = fn.lower(params).compile(
            compiler_options={"xla_allow_excess_precision": False})
    (wloss, wlogits), wgrads = fn(params)

    live = tree_map(lambda t: t.requires_grad_(True),
                    bridge.tree_to_tensors(params))
    tfe = None if fe is None else torch.tensor(fe)
    logits, _ = ttransformer.forward(live, tcfg, torch.tensor(toks),
                                     frontend_emb=tfe, kind="train")
    loss = lm_loss(logits, torch.tensor(labels))
    flat = flatten_with_keys(live)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)

    def rel(a, b):
        return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)

    assert abs(loss.item() - float(wloss)) <= REL_TOL * abs(float(wloss))
    assert rel(np.asarray(wlogits), logits.detach().numpy()) < REL_TOL
    want = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(wgrads)[0]}
    assert set(want) == set(flat)
    for (key, leaf), g in zip(flat.items(), grads):
        got = np.zeros(leaf.shape, np.float32) if g is None else g.numpy()
        tol = BF16_REL_TOL if (jcfg.family == "audio"
                               and _bf16_encoder_leaf(key)) else REL_TOL
        assert rel(want[key], got) < tol, key
    # the training forward computes the prefill forward's logits
    with torch.no_grad():
        plain, _ = ttransformer.forward(bridge.tree_to_tensors(params), tcfg,
                                        torch.tensor(toks), frontend_emb=tfe)
    assert rel(plain.numpy(), logits.detach().numpy()) < REL_TOL
