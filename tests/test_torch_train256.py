"""Training at head dim 256 (GPT-J-6B's, Qwen3-Next's) in cubecl_tpu_torch
against cubecl_tpu: the gradients of ``flash_attention`` at D 256 (causal
or not, 4 query heads on 1 and on 4 kv heads, S 128 and a ragged 100), of
``flash_attention_padded`` from D 192 and 160 (padded to 256), of the
masked options at D 256 (``kv_len``, segment ids, a window), the llama at
head dim 256 (loss, every gradient and one SGD step of ``make_train_step``)
against ``jax.value_and_grad`` of the JAX ``loss_fn`` and the JAX
``make_train_step``, and the refusal boundary: past 256 under grad, and
the block-sparse functions at 256.

The port runs ``_FlashAttention`` with its plain halves on these CPU
tensors (on the card A1's and A3/A4's D 256 instances of
csrc/flash_attention.cu and csrc/flash_attention_bwd.cu, held to the same
plain versions by tests/test_torch_cuda.py); the JAX kernels run in Pallas
interpret mode under ``jax.jit`` (128 blocks). f32 tolerances, summation
order only: forward atol 2e-5 / rtol 1e-4, gradients 1e-5 / 1e-4
(tests/test_torch_attention_options.py's); the llama's loss to 1e-5
relative, every gradient leaf to 1e-4 of its max-abs and the weights after
one step to 1e-6 relative (tests/test_torch_train.py's). Meta tensors stand
in for the card in the refusal tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu.ops import attention as J
from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.ops import attention as fa

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=1e-5, rtol=1e-4)
BLK = 128  # the JAX kernels' blocks in interpret mode
D = 256
LR = 1e-3


def _inputs(seed, H, Hkv, S, Dq=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, S, Dq), dtype=np.float32)
    k = rng.standard_normal((1, Hkv, S, Dq), dtype=np.float32)
    v = rng.standard_normal((1, Hkv, S, Dq), dtype=np.float32)
    do = rng.standard_normal((1, H, S, Dq), dtype=np.float32)
    return q, k, v, do


def _port(fn, q, k, v, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fn(*leaves)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax(fn, q, k, v, do):
    """The output and ``jax.vjp`` of ``fn`` under jit, fed kv heads
    repeated to H as the JAX models feed them; dk, dv come back summed over
    each group through the repeat."""
    rep = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return fn(q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1))

    def both(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(do)

    o, grads = jax.jit(both)(*(jnp.asarray(a) for a in (q, k, v, do)))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _check(got, ref):
    (o, grads), (o_ref, refs) = got, ref
    np.testing.assert_allclose(o, o_ref, **FWD)
    for name, g, r in zip("qkv", grads, refs):
        np.testing.assert_allclose(g, r, **GRAD, err_msg=f"d{name}")


# -- flash attention's gradients at D 256 --------------------------------------

@pytest.mark.parametrize("S", [128, 100], ids=["S128", "S100"])
@pytest.mark.parametrize("Hkv", [1, 4], ids=["gqa4on1", "mha4"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_grads_match_jax(causal, Hkv, S):
    """dq, dk, dv of flash_attention at D 256 against the JAX custom_vjp
    (A1's forward, A3's dK/dV and A4's dQ in interpret mode), the kv
    heads' gradients summed over their query heads; a ragged S 100."""
    q, k, v, do = _inputs(S + 7 * Hkv + causal, 4, Hkv, S)
    got = _port(lambda q, k, v: fa.flash_attention(q, k, v, causal),
                q, k, v, do)
    ref = _jax(lambda q, k, v: J.flash_attention(
        q, k, v, causal, None, BLK, BLK, True), q, k, v, do)
    _check(got, ref)


@pytest.mark.parametrize("Dq", [192, 160])
def test_padded_grads_match_jax(Dq):
    """flash_attention_padded past 128 at a ragged S: D padded to 256 (the
    scale from the real D) as the JAX function pads it for its exact
    kernel; the grads sliced back to Dq through autograd."""
    q, k, v, do = _inputs(Dq, 2, 1, 100, Dq)
    got = _port(lambda q, k, v: fa.flash_attention_padded(q, k, v),
                q, k, v, do)
    assert got[1][0].shape == (1, 2, 100, Dq)
    ref = _jax(lambda q, k, v: J.flash_attention_padded(
        q, k, v, True, None, BLK, BLK, True), q, k, v, do)
    _check(got, ref)


def _seg_ids(S):
    """Segment 0 ends inside tile 0 and segment 2 starts inside tile 1 of
    the 128-row tiles: some tile pairs share ids across a boundary."""
    seg = np.zeros((1, S), np.int32)
    seg[:, 50:200] = 1
    seg[:, 200:] = 2
    return seg


@pytest.mark.parametrize("option", ["kv_len", "segments", "window"])
def test_option_grads_match_jax(option):
    """The masked options at D 256 through their public functions, forward
    and gradients: keys past kv_len 200 of 256, packed segments, a
    sliding window of 100 (flash_attention_local)."""
    q, k, v, do = _inputs(len(option), 2, 2, 256)
    if option == "kv_len":
        port = lambda q, k, v: fa.flash_attention(  # noqa: E731
            q, k, v, True, kv_len=200)
        ref = lambda q, k, v: J.flash_attention(  # noqa: E731
            q, k, v, True, None, BLK, BLK, True, 200)
    elif option == "segments":
        seg = _seg_ids(256)
        port = lambda q, k, v: fa.flash_attention_segmented(  # noqa: E731
            q, k, v, seg, None, True)
        ref = lambda q, k, v: J.flash_attention_segmented(  # noqa: E731
            q, k, v, jnp.asarray(seg), None, True, None, BLK, BLK, True)
    else:
        port = lambda q, k, v: fa.flash_attention_local(  # noqa: E731
            q, k, v, 100, 0, True)
        ref = lambda q, k, v: J.flash_attention_local(  # noqa: E731
            q, k, v, 100, 0, True, None, BLK, BLK, True)
    _check(_port(port, q, k, v, do), _jax(ref, q, k, v, do))


# -- the llama at head dim 256 ---------------------------------------------

HD256 = dict(vocab=64, d_model=512, n_heads=2, n_kv_heads=1, n_layers=2,
             d_ff=128, seq=129, use_framework_kernels=False)


@pytest.fixture(scope="module")
def train_case():
    """The JAX loss, gradients and one ``make_train_step`` step at S 128
    (its exact flash route at head dim 256: A1, A3 and A4 in interpret
    mode), computed once."""
    jcfg = jllama.LlamaConfig(**HD256)
    jparams = jllama.init_params(jcfg, seed=5)
    tokens = np.random.default_rng(2).integers(0, HD256["vocab"], (2, 129),
                                               dtype=np.int32)
    loss, grads = jax.value_and_grad(jllama.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg)
    new, step_loss = jllama.make_train_step(jcfg, LR)(jparams,
                                                      jnp.asarray(tokens))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    leaves = lambda t: {n: x.numpy() for n, x in  # noqa: E731
                        llama.params_from_jax(np_tree(t)).items()}
    return dict(tokens=torch.from_numpy(tokens),
                state=llama.params_from_jax(np_tree(jparams)),
                loss=float(loss), grads=leaves(grads), new=leaves(new),
                step_loss=float(step_loss))


def _model(case):
    model = llama.Llama(llama.LlamaConfig(**HD256), device="cpu")
    model.load_state_dict(case["state"])
    assert model.cfg.head_dim == D
    return model


def _grads_close(model, ref):
    for name, p in model.named_parameters():
        r = ref[name]
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(p.grad.numpy() - r).max())
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"


def test_llama_loss_and_grads_match_jax(train_case):
    """loss_fn through flash_attention at head dim 256 (the plain halves
    of _FlashAttention here): the loss to 1e-5 relative, every gradient
    leaf to 1e-4 of its max-abs."""
    model = _model(train_case).requires_grad_(True)
    loss = llama.loss_fn(model, train_case["tokens"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), train_case["loss"], rtol=1e-5)
    _grads_close(model, train_case["grads"])


def test_llama_train_step_matches_jax(train_case):
    """One make_train_step SGD step: its loss, the weights after it and
    the gradients it left, against the JAX make_train_step's."""
    model = _model(train_case)
    loss = llama.make_train_step(model.cfg, LR)(model, train_case["tokens"])
    np.testing.assert_allclose(loss.item(), train_case["step_loss"],
                               rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   train_case["new"][name], rtol=1e-6,
                                   atol=1e-9, err_msg=name)
    _grads_close(model, train_case["grads"])


def test_models_route_head_dim_256_to_the_exact_function():
    """As the JAX llama's exact64 branch: flash_attention at 256, the
    padded function at 160 and 192 (padded to 256 inside)."""
    assert fa.flash_for_head_dim(256, 16) is fa.flash_attention
    assert fa.flash_for_head_dim(256, 2) is fa.flash_attention
    for hd in (160, 192):
        assert fa.flash_for_head_dim(hd, 8) is fa.flash_attention_padded


# -- the boundary --------------------------------------------------------------

@pytest.mark.parametrize("route", ["exact", "padded 160", "padded 192"])
def test_a_training_pass_at_256_is_not_refused(route):
    """Off the CPU under grad, D 256 (and D 160/192 padded to it) passes
    the Function's check and goes on to the kernels, which want a CUDA
    tensor (meta tensors stand in for the card's)."""
    Dq = 256 if route == "exact" else int(route.split()[1])
    q = torch.zeros(1, 2, 64, Dq, device="meta", requires_grad=True)
    fn = fa.flash_attention if route == "exact" else \
        fa.flash_attention_padded
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, q, q)


@pytest.mark.parametrize("Dq", [288, 384, 512])
def test_past_256_a_training_pass_is_refused(Dq):
    """Past 256 the Function refuses a pass under grad at the forward,
    naming ROADMAP Queue 2a, and the padded route refuses it with or
    without grad; the CPU runs the plain versions there."""
    q = torch.zeros(1, 2, 64, Dq, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="Queue 2a"):
        fa.flash_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="Queue 2a"):
        fa.flash_attention_padded(q.detach(), q.detach(), q.detach())
    x = torch.from_numpy(_inputs(Dq, 1, 1, 40, Dq)[0]).requires_grad_()
    fa.flash_attention(x, x, x).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "train"])
def test_block_sparse_stays_unported_at_256(grad):
    """A5-A7 are built at D 256 and not past it: off the CPU (meta tensors
    stand in for the card's) the block-sparse function goes on to the
    kernels at D 256, which want a CUDA tensor, and raises
    NotImplementedError naming ROADMAP Queue 2a at D 288, with or without
    grad; on the CPU it runs its plain versions."""
    q = torch.zeros(1, 2, 256, D, device="meta", requires_grad=grad)
    bm = np.ones((2, 2), bool)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_block_sparse(q, q, q, bm, True, None, 128, 128)
    q = torch.zeros(1, 2, 256, D + 32, device="meta", requires_grad=grad)
    with pytest.raises(NotImplementedError, match="Queue 2a"):
        fa.flash_attention_block_sparse(q, q, q, bm, True, None, 128, 128)
    x = torch.from_numpy(_inputs(11, 2, 2, 256)[0]).requires_grad_(grad)
    o = fa.flash_attention_block_sparse(x, x, x, bm, True, None, 128, 128)
    torch.testing.assert_close(o, fa.flash_attention_plain(x, x, x, True))
