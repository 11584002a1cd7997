"""Training of cubecl_tpu_torch.models.mamba against cubecl_tpu.models.mamba.

The config of ``tests/test_torch_mamba.py`` (vocab 61, d 32, 2 layers,
d_state 16), the JAX ``init_params`` loaded through ``params_from_jax`` and
tokens (B 2, L 12 + 1) from a numpy seed. The JAX side takes
``jax.value_and_grad`` of its ``loss_fn`` at ``scan_impl="assoc"`` (XLA's
associative scan; its Pallas S1 has no gradient), computed once a module.
The port runs S1's autograd Function with its plain halves on these CPU
tensors (``scan_impl="chunked"``: the time loop forward, the reverse scan
``scan_chunked_core_backward_plain`` backward) or the doubling scan under
autograd (``"assoc"``, and ``"auto"`` on the CPU).

Tolerances, PERF.md §2's f32 train step: the loss to 1e-5 relative, every
gradient leaf to 1e-4 of its max-abs (the same f32 math summed in other
orders through two layers). After three SGD steps the loss of each step to
1e-5 relative and each leaf's change from its start to 1e-4 of that
change's max-abs, plus one f32 rounding of ``p - lr * g`` a step (2^-23
of the leaf's max-abs). S1's backward against autograd through the plain
time loop: f32 atol 1e-5 / rtol 1e-4 (a reverse scan against autograd's
own order); bf16 atol/rtol 1e-2, one bf16 rounding apart (da takes the stored
bf16 h, autograd the f32 carry).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import mamba as jmamba
from cubecl_tpu_torch.models import mamba
from cubecl_tpu_torch.ops import ssm

CFG = dict(vocab=61, d_model=32, n_layers=2, seq=12)
B = 2
LR = 0.05
STEPS = 3


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _leaves(sd):
    return {k: v.numpy() for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX loss, gradients and three SGD steps on one batch."""
    jcfg = jmamba.MambaConfig(**CFG, scan_impl="assoc")
    jparams = jmamba.init_params(jcfg, seed=61)
    toks = np.random.RandomState(63).randint(
        0, CFG["vocab"], (B, CFG["seq"] + 1)).astype(np.int32)
    loss, grads = jax.value_and_grad(jmamba.loss_fn)(
        jparams, jnp.asarray(toks), jcfg)
    step = jax.jit(jmamba.make_train_step(jcfg, LR))
    params, losses = jparams, []
    for _ in range(STEPS):
        params, l_ = step(params, jnp.asarray(toks))
        losses.append(float(l_))
    return dict(state=mamba.params_from_jax(_np_tree(jparams)),
                toks=toks, loss=float(loss),
                grads=_leaves(mamba.params_from_jax(_np_tree(grads))),
                steps=_leaves(mamba.params_from_jax(_np_tree(params))),
                step_losses=losses)


def _port(scan_impl):
    ref = _jax()
    model = mamba.Mamba(mamba.MambaConfig(**CFG, scan_impl=scan_impl),
                        device="cpu")
    model.load_state_dict(ref["state"])
    return model, torch.from_numpy(ref["toks"])


def assert_close_by_max(got, ref, what, atol=None):
    """Each leaf within 1e-4 of its max-abs (plus ``atol[name]``)."""
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        bound = 1e-4 * max(float(np.abs(r).max()), 1e-30) \
            + (atol[name] if atol else 0.0)
        err = float(np.abs(got[name] - r).max())
        assert err <= bound, f"{what} {name}: {err} > {bound}"


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("scan_impl", ["chunked", "assoc", "auto"])
def test_loss_and_grads_match_jax(scan_impl, kernels):
    """Every weight gets the JAX gradient; S1's Function launches nothing
    on the CPU (neither its forward nor its backward kernel)."""
    ref = _jax()
    model, toks = _port(scan_impl)
    model.requires_grad_(True)
    n = (ssm.scan_chunked_core.launches,
         ssm.scan_chunked_core_backward.launches)
    loss = mamba.loss_fn(model, toks, kernels=kernels)
    loss.backward()
    assert (ssm.scan_chunked_core.launches,
            ssm.scan_chunked_core_backward.launches) == n
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert all(np.abs(g).max() > 0 for g in got.values())
    assert_close_by_max(got, ref["grads"], "grad")


@pytest.mark.parametrize("scan_impl", ["chunked", "assoc"])
def test_three_steps_match_jax(scan_impl):
    """Three in-place SGD steps of ``make_train_step`` on one batch: each
    step's loss and each weight's change against the JAX steps; the loss
    falls from step to step."""
    ref = _jax()
    model, toks = _port(scan_impl)
    start = {k: p.detach().clone().numpy()
             for k, p in model.named_parameters()}
    step = mamba.make_train_step(model.cfg, LR)
    losses = [step(model, toks) for _ in range(STEPS)]
    assert not any(l_.requires_grad for l_ in losses)
    np.testing.assert_allclose([l_.item() for l_ in losses],
                               ref["step_losses"], rtol=1e-5)
    assert losses[0] > losses[1] > losses[2]
    got = {k: p.detach().numpy() - start[k]
           for k, p in model.named_parameters()}
    rounding = {k: STEPS * 2.0 ** -23 * float(np.abs(v).max())
                for k, v in start.items()}
    assert_close_by_max(got, {k: v - start[k]
                              for k, v in ref["steps"].items()}, "change of",
                        rounding)


def test_train_step_refuses_another_config():
    model, toks = _port("chunked")
    step = mamba.make_train_step(mamba.MambaConfig(**CFG), LR)
    with pytest.raises(ValueError, match="another config"):
        step(model, toks)


def _scan_inputs(seed, B_, L, DN, dtype):
    rng = np.random.default_rng(seed)
    af = np.exp(-np.abs(rng.standard_normal((B_, L, DN)))) * 0.95
    uf, dh = (rng.standard_normal((B_, L, DN)) * 0.5 for _ in range(2))
    return [torch.from_numpy(t.astype(np.float32)).to(dtype)
            for t in (af, uf, dh)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B_,L,DN", [(2, 37, 24), (1, 1, 8), (3, 9, 5)])
def test_backward_plain_matches_autograd_of_the_loop(dtype, B_, L, DN):
    """``scan_chunked_core_backward_plain`` on the stored h equals autograd
    through ``scan_chunked_core_plain``'s time loop, and the autograd
    Function of ``scan_chunked_core`` gives it; da at t = 0 is zero."""
    af, uf, dh = _scan_inputs(L * DN + B_, B_, L, DN, dtype)
    leaves = [t.clone().requires_grad_() for t in (af, uf)]
    h = ssm.scan_chunked_core_plain(*leaves)
    h.backward(dh)
    da, du = ssm.scan_chunked_core_backward_plain(af, h.detach(), dh)
    assert da.dtype == du.dtype == dtype
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(da, leaves[0].grad, **tol)
    torch.testing.assert_close(du, leaves[1].grad, **tol)
    assert not da[:, 0].any()

    fn_leaves = [t.clone().requires_grad_() for t in (af, uf)]
    out = ssm.scan_chunked_core(*fn_leaves)
    assert torch.equal(out.detach(), h.detach())
    out.backward(dh)
    assert torch.equal(fn_leaves[0].grad, da)
    assert torch.equal(fn_leaves[1].grad, du)


def test_kernels_flag_and_no_grad_route():
    """``selective_scan_chunked`` under autograd with ``kernels=False``
    runs the Function's plain halves: the same grads as the kernel route
    on the CPU; without grad the forward alone runs and keeps no graph."""
    rng = np.random.RandomState(5)
    Bn, L, D, N = 2, 10, 6, 4
    x = torch.from_numpy(rng.randn(Bn, L, D).astype(np.float32))
    delta = torch.from_numpy((np.abs(rng.randn(Bn, L, D)) * .1)
                             .astype(np.float32))
    A = torch.from_numpy((-np.abs(rng.randn(D, N))).astype(np.float32))
    Bc, Cc = (torch.from_numpy(rng.randn(Bn, L, N).astype(np.float32))
              for _ in range(2))
    grads = []
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, delta, A, Bc)]
        y = ssm.selective_scan_chunked(*leaves, Cc, kernels=kernels)
        y.square().sum().backward()
        grads.append([t.grad for t in leaves])
    for g, p in zip(*grads):
        assert torch.equal(g, p)
    leaves = [t.clone().requires_grad_() for t in (x, delta, A, Bc)]
    naive = ssm.selective_scan_naive(*leaves, Cc)
    naive.square().sum().backward()
    for g, r in zip(grads[0], (t.grad for t in leaves)):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-4)
    with torch.no_grad():
        assert not ssm.selective_scan_chunked(x, delta, A.requires_grad_(),
                                              Bc, Cc).requires_grad
