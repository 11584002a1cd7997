"""cubecl_tpu_torch.models.mamba against cubecl_tpu.models.mamba.

The config of ``tests/test_models.py::test_mamba_forward_decode_equivalence``
(vocab 61, d 32, 2 layers, d_state 16, L 12), the JAX ``init_params``
loaded through ``params_from_jax`` and tokens from a numpy seed. Per
``scan_impl`` the JAX package runs its associative scan (``auto`` and
``assoc`` on the CPU) or S1 in Pallas interpret mode (``chunked``); the
port runs the doubling scan or S1's plain version.

Tolerances: logits atol 2e-5 / rtol 1e-4 against the JAX package (the same
f32 recurrence in other orders through two layers); decode logits against
a forward atol 2e-4 / rtol 1e-3, the JAX package's own serving contract
(a recurrent step against a scan, ``tests/test_models.py:787-809``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import mamba as jmamba
from cubecl_tpu_torch.models import mamba
from cubecl_tpu_torch.ops import ssm

ATOL, RTOL = 2e-5, 1e-4
DEC_ATOL, DEC_RTOL = 2e-4, 1e-3
CFG = dict(vocab=61, d_model=32, n_layers=2, seq=12)
B = 2


@pytest.fixture(scope="module")
def jax_model():
    jcfg = jmamba.MambaConfig(**CFG)
    jparams = jmamba.init_params(jcfg, seed=61)
    toks = np.random.RandomState(62).randint(0, CFG["vocab"],
                                             (B, CFG["seq"])).astype(np.int32)
    return jcfg, jparams, toks


def _port(jparams, **over):
    model = mamba.Mamba(mamba.MambaConfig(**{**CFG, **over}), device="cpu")
    model.load_state_dict(mamba.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return model


def test_params_from_jax(jax_model):
    _jcfg, jparams, _toks = jax_model
    sd = mamba.params_from_jax(jax.tree.map(np.asarray, jparams))
    model = mamba.Mamba(mamba.MambaConfig(**CFG), device="cpu")
    model.load_state_dict(sd, strict=True)
    assert model.layers[1].A_log.shape == (64, 16)
    np.testing.assert_array_equal(model.layers[1].x_proj.numpy(),
                                  np.asarray(jparams["layers"][1]["x_proj"]))
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(jparams["embed"]))


@pytest.mark.parametrize("scan_impl", ["auto", "assoc", "chunked"])
def test_forward_matches_jax(jax_model, scan_impl):
    jcfg, jparams, toks = jax_model
    jcfg = dataclasses.replace(jcfg, scan_impl=scan_impl)
    ref = np.asarray(jmamba.forward(jparams, jnp.asarray(toks), jcfg))
    model = _port(jparams, scan_impl=scan_impl)
    n = ssm.scan_chunked_core.launches
    got = mamba.forward(model, torch.from_numpy(toks))
    assert ssm.scan_chunked_core.launches == n   # no kernel on the CPU
    assert got.shape == (B, CFG["seq"], CFG["vocab"])
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_decode_steps_match_jax_and_forward(jax_model):
    """Teacher-forced decode: each step's logits against the JAX step's
    (atol 2e-5 / rtol 1e-4) and against the port's own forward at that
    position (the serving contract's atol 2e-4 / rtol 1e-3); the state
    keeps its size."""
    jcfg, jparams, toks = jax_model
    model = _port(jparams, scan_impl="chunked")
    full = mamba.forward(model, torch.from_numpy(toks)).numpy()
    jstate = jmamba.decode_init(jcfg, batch=B)
    state = mamba.decode_init(model.cfg, B, device="cpu")
    for t in range(CFG["seq"]):
        jl, jstate = jmamba.decode_step(jparams, jstate,
                                        jnp.asarray(toks[:, t]), jcfg)
        lg, state = mamba.decode_step(model, state,
                                      torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(lg.numpy(), full[:, t], atol=DEC_ATOL,
                                   rtol=DEC_RTOL)
    for st, jst in zip(state, jstate):
        for k in ("conv", "h"):
            assert st[k].shape == jst[k].shape
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       atol=ATOL, rtol=RTOL)


def test_loss_matches_jax(jax_model):
    jcfg, jparams, toks = jax_model
    ref = float(jmamba.loss_fn(jparams, jnp.asarray(toks), jcfg))
    got = float(mamba.loss_fn(_port(jparams), torch.from_numpy(toks)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_short_sequences_and_kernels_flag():
    """A sequence shorter than the conv window (which the JAX shifted adds
    do not take) equals the first positions of a longer one; on the CPU
    ``kernels=False`` changes nothing."""
    cfg = mamba.MambaConfig(**CFG, scan_impl="chunked")
    model = mamba.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, 8), dtype=np.int32))
    full = mamba.forward(model, toks)
    for L in (1, 2):
        np.testing.assert_allclose(mamba.forward(model, toks[:, :L]).numpy(),
                                   full[:, :L].numpy(), atol=1e-6, rtol=1e-5)
    assert torch.equal(full, mamba.forward(model, toks, kernels=False))


def test_init_params_recipe():
    """The port's own init follows the JAX recipe: S4D-real A, dt_bias the
    inverse softplus of a step in [1e-3, 1e-1], unit norms and D."""
    cfg = mamba.MambaConfig(**CFG)
    model = mamba.init_params(cfg, seed=0, device="cpu")
    layer = model.layers[0]
    np.testing.assert_allclose(torch.exp(layer.A_log).numpy(),
                               np.tile(np.arange(1, 17, dtype=np.float32),
                                       (cfg.d_inner, 1)), rtol=1e-6)
    dt = torch.nn.functional.softplus(layer.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-4)
    assert torch.equal(layer.D, torch.ones(cfg.d_inner))
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="scan_impl"):
        mamba.Mamba(mamba.MambaConfig(scan_impl="pallas"), device="cpu")


def test_models_and_states_default_to_the_card():
    """Models and decode states are built on the card unless asked
    otherwise (checked by signature: nothing is built here)."""
    import inspect

    for fn in (mamba.init_params, mamba.Mamba, mamba.MambaLayer,
               mamba.decode_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
