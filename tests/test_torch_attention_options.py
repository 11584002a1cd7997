"""The options of flash attention (``kv_len``, segment ids, a sliding window)
and the four public functions over them: cubecl_tpu_torch.ops.attention
against cubecl_tpu.ops.attention in Pallas interpret mode (128 blocks),
forward and gradients (``jax.vjp``).

On these CPU tensors the port runs ``_FlashAttention`` with its plain halves
(``flash_attention_plain`` / ``flash_attention_backward_plain`` with the
options as one boolean mask), so this holds the wrappers' padding, the
masks and the Function's wiring; ``tests/test_torch_cuda.py`` holds the
kernels against the same plain versions on the card. Inputs and the
upstream do come from a numpy seed; the JAX side gets the kv heads repeated
where the port takes GQA. f32: forward atol 2e-5 / rtol 1e-4 (as
``tests/test_torch_attention.py``), gradients 1e-5 / 1e-4 (as
``tests/test_torch_attention_grad.py``).

F16 (ROADMAP Queue 3): a row with no live key gets zeros from the port; the
JAX kernels give it the mean of V over whichever columns passed their tile
tests. Those rows are held to zero, the others to JAX.

Also: the llama at head dims 96 (the padded route) and 32 (the packed
route) against the JAX llama through ``params_from_jax``, loss and grads,
and the head-dim routing of both models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu.ops import attention as J
from cubecl_tpu_torch.models import llama, transformer
from cubecl_tpu_torch.ops import attention as fa

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=1e-5, rtol=1e-4)
BLK = 128  # the JAX kernels' blocks in interpret mode


def _inputs(seed, B, H, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32)
    do = rng.standard_normal((B, H, Sq, D), dtype=np.float32)
    return q, k, v, do


def _port(fn, q, k, v, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fn(*leaves)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax(fn, q, k, v, do):
    """jax.vjp of ``fn`` fed kv heads repeated to H; dk, dv come back summed
    over each group through the repeat."""
    rep = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return fn(q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1))

    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _check(got, ref):
    (o, grads), (o_ref, refs) = got, ref
    np.testing.assert_allclose(o, o_ref, **FWD)
    for name, g, r in zip("qkv", grads, refs):
        np.testing.assert_allclose(g, r, **GRAD, err_msg=f"d{name}")


def _seg_ids(B, S):
    """tests/test_ops.py:343-346: at 128 blocks segment 0 ends inside tile
    0 and segment 2 starts inside tile 2, so some tile pairs are range
    disjoint (skipped whole) and others share ids across a boundary."""
    seg = np.zeros((B, S), np.int32)
    seg[:, 100:300] = 1
    seg[:, 300:] = 2
    return seg


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv,D", [(2, 2, 64), (4, 2, 128)],
                         ids=["d64", "gqa4on2_d128"])
def test_segmented_matches_jax(causal, H, Hkv, D):
    q, k, v, do = _inputs(D + causal, 1, H, Hkv, 512, 512, D)
    seg = _seg_ids(1, 512)
    got = _port(lambda q, k, v: fa.flash_attention_segmented(
        q, k, v, seg, None, causal), q, k, v, do)
    ref = _jax(lambda q, k, v: J.flash_attention_segmented(
        q, k, v, jnp.asarray(seg), None, causal, None, BLK, BLK, True),
        q, k, v, do)
    _check(got, ref)


@pytest.mark.parametrize("left,right,causal", [(128, 0, True),
                                               (64, 64, False)])
def test_local_matches_jax(left, right, causal):
    q, k, v, do = _inputs(left + right, 1, 2, 1, 384, 384, 64)
    got = _port(lambda q, k, v: fa.flash_attention_local(
        q, k, v, left, right, causal), q, k, v, do)
    ref = _jax(lambda q, k, v: J.flash_attention_local(
        q, k, v, left, right, causal, None, BLK, BLK, True), q, k, v, do)
    _check(got, ref)


@pytest.mark.parametrize("D", [32, 80, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_matches_jax_at_ragged_lengths(D, causal):
    """Head dims outside {64, 128} and S = 200 (JAX pads S to 256 and masks
    its padded keys by kv_len; the port pads D only)."""
    q, k, v, do = _inputs(D, 1, 2, 1, 200, 200, D)
    got = _port(lambda q, k, v: fa.flash_attention_padded(q, k, v, causal),
                q, k, v, do)
    ref = _jax(lambda q, k, v: J.flash_attention_padded(
        q, k, v, causal, None, BLK, BLK, True), q, k, v, do)
    _check(got, ref)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("window", [None, (64, 0)], ids=["full", "w64"])
def test_packed_matches_jax(D, window):
    """A8's heads packed on the TPU's lanes (g = 128 // D); on the port A1's
    kernel at D 64, D 32 padded to it."""
    q, k, v, do = _inputs(D + (window is None), 1, 4, 4, 256, 256, D)
    got = _port(lambda q, k, v: fa.flash_attention_packed(
        q, k, v, True, window=window), q, k, v, do)
    ref = _jax(lambda q, k, v: J.flash_attention_packed(
        q, k, v, True, None, BLK, BLK, True, window), q, k, v, do)
    _check(got, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_kv_len_matches_jax(causal):
    q, k, v, do = _inputs(7 + causal, 1, 2, 2, 256, 256, 64)
    got = _port(lambda q, k, v: fa.flash_attention(
        q, k, v, causal, kv_len=200), q, k, v, do)
    ref = _jax(lambda q, k, v: J.flash_attention(
        q, k, v, causal, None, BLK, BLK, True, 200), q, k, v, do)
    _check(got, ref)


def test_kv_len_past_the_keys_is_the_dense_call():
    q, k, v, _ = _inputs(3, 1, 2, 2, 64, 64, 64)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert fa._Mask.of(t[0], t[1], kv_len=64) is None
    assert torch.equal(fa.flash_attention(*t, kv_len=64),
                       fa.flash_attention(*t))


def _f16_segments():
    """Ids of the keys miss segment 7 of the queries: rows 200..263 have no
    live key."""
    seg_q = _seg_ids(1, 512)
    seg_kv = seg_q.copy()
    seg_q[:, 200:264] = 7
    return seg_q, seg_kv, (seg_q == 7)[0]


@pytest.mark.parametrize("case", ["segments", "window"])
def test_f16_rows_are_zero_and_the_rest_match_jax(case):
    """F16: rows with no live key get zeros and pass nothing back; every
    other row and the gradients of an upstream that is zero on the dead
    rows match JAX."""
    if case == "segments":
        q, k, v, do = _inputs(16, 1, 2, 2, 512, 512, 64)
        seg_q, seg_kv, dead = _f16_segments()

        def port(q, k, v):
            return fa.flash_attention_segmented(q, k, v, seg_q, seg_kv, True)

        def ref(q, k, v):
            return J.flash_attention_segmented(
                q, k, v, jnp.asarray(seg_q), jnp.asarray(seg_kv), True,
                None, BLK, BLK, True)
    else:  # a band (0, 0) with Sq > Skv: rows from Skv on see no key
        q, k, v, do = _inputs(17, 1, 2, 2, 256, 128, 64)
        dead = np.arange(256) >= 128

        def port(q, k, v):
            return fa.flash_attention_local(q, k, v, 0, 0, False)

        def ref(q, k, v):
            return J.flash_attention_local(q, k, v, 0, 0, False, None, BLK,
                                           BLK, True)
    do[:, :, dead] = 0.0
    o, grads = _port(port, q, k, v, do)
    o_ref, refs = _jax(ref, q, k, v, do)
    assert np.all(o[:, :, dead] == 0.0)
    np.testing.assert_allclose(o[:, :, ~dead], o_ref[:, :, ~dead], **FWD)
    for name, g, r in zip("qkv", grads, refs):
        np.testing.assert_allclose(g, r, **GRAD, err_msg=f"d{name}")
    # an upstream only on the dead rows reaches no input
    only = np.zeros_like(do)
    only[:, :, dead] = 1.0
    _, grads = _port(port, q, k, v, only)
    for name, g in zip("qkv", grads):
        assert np.all(g == 0.0), f"d{name}"
    # the lse of the dead rows is 0, as the kernels write it
    t = [torch.from_numpy(a) for a in (q, k, v)]
    mask = fa._Mask.of(*t[:2], seg=(seg_q, seg_kv)) if case == "segments" \
        else fa._Mask.of(*t[:2], window=(0, 0))
    _, lse = fa.flash_attention_plain(*t, case == "segments",
                                      return_lse=True, **mask.plain())
    assert np.all(lse.numpy()[:, :, dead] == 0.0)


def test_tile_ranges_cover_ragged_tiles():
    ids = torch.tensor([[0] * 60 + [1] * 10 + [3] * 30,
                        [5] * 64 + [2] * 36], dtype=torch.int32)
    lo, hi = fa._tile_ranges(ids)
    assert lo.tolist() == [[0, 1], [5, 2]]
    assert hi.tolist() == [[1, 3], [5, 2]]


def test_kernel_args_lay_out_what_the_kernels_read():
    """``_Mask.kernel_args``: no band is Sq + Skv a side, kv_len defaults
    to Skv, and ``ranges`` holds q_lo, q_hi, k_lo, k_hi, then the q and kv
    pairs' segment walks (``csrc/flash_tiles.cuh::make_mask``)."""
    q = torch.zeros(2, 1, 200, 64)
    k = torch.zeros(2, 1, 130, 64)
    mask = fa._Mask.of(q, k, kv_len=100)
    assert mask.kernel_args(200, 130) == (None, None, None, 100, 330, 330)
    mask = fa._Mask.of(q, k, window=(7, 400))
    assert mask.kernel_args(200, 130)[3:] == (130, 7, 330)
    ids_q = torch.tensor([[0] * 100 + [1] * 100, [2] * 200])
    ids_k = torch.tensor([[1] * 130, [2] * 70 + [3] * 60])
    mask = fa._Mask.of(q, k, seg=(ids_q, ids_k))
    sq, sk, ranges, kv_len, left, right = mask.kernel_args(200, 130)
    assert (sq, sk) == (mask.seg[0].data_ptr(), mask.seg[1].data_ptr())
    assert ranges == mask._ranges.data_ptr() and (kv_len, left, right) == \
        (130, 330, 330)
    (qlo, qhi), (klo, khi) = (fa._tile_ranges(i) for i in mask.seg)
    want = torch.cat([t.reshape(-1) for t in (
        qlo, qhi, klo, khi, fa._seg_walk(qlo, qhi, klo, khi),
        fa._seg_walk(klo, khi, qlo, qhi))])
    assert mask._ranges.dtype == torch.int32
    assert mask._ranges.tolist() == want.tolist()
    # B x 4 q tiles, B x 3 kv tiles, B x 2 q pairs x 2, B x 2 kv pairs x 2
    assert mask._ranges.numel() == 2 * (2 * 4 + 2 * 3 + 2 * 2 + 2 * 2)
    # row 0's first q pair (ids 0..1) reaches kv tiles 0..2 (id 1); row 1's
    # kv pair 1 (tile 2, ids 3) reaches no q tile
    walk_q = fa._seg_walk(qlo, qhi, klo, khi)
    walk_k = fa._seg_walk(klo, khi, qlo, qhi)
    assert walk_q[0, 0].tolist() == [0, 3]
    assert walk_k[1, 1].tolist()[1] <= walk_k[1, 1].tolist()[0]


def test_options_are_checked():
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="left"):
        fa.flash_attention_local(q, q, q, -1)
    with pytest.raises(ValueError, match="segment ids"):
        fa.flash_attention_segmented(q, q, q, np.zeros((1, 63), np.int32))


def test_padded_past_128_runs_on_the_cpu():
    """D 160: padded to 256 as on the card, where A1's forward is built at
    256, equal to the plain route at 160."""
    q, k, v, _ = _inputs(9, 1, 2, 2, 40, 40, 160)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    torch.testing.assert_close(fa.flash_attention_padded(*t),
                               fa.flash_attention_plain(*t))


# -- the models route by head dim ---------------------------------------------

LR = 1e-3
LLAMAS = {
    # head dim 96 (Phi-3-mini's): the padded route on both sides
    "hd96": dict(vocab=64, d_model=192, n_heads=2, n_kv_heads=1,
                 n_layers=2, d_ff=128, seq=160, use_framework_kernels=False),
    # head dim 32, heads a multiple of 4: the packed route on both sides
    "hd32": dict(vocab=64, d_model=128, n_heads=4, n_kv_heads=2,
                 n_layers=2, d_ff=128, seq=160, use_framework_kernels=False),
}


@pytest.fixture(scope="module", params=sorted(LLAMAS))
def llama_case(request):
    """The JAX loss and gradients at S = 128 (its exact routes need S % 128
    == 0), computed once per config."""
    cfg = LLAMAS[request.param]
    jcfg = jllama.LlamaConfig(**cfg)
    jparams = jllama.init_params(jcfg, seed=4)
    tokens = np.random.default_rng(1).integers(0, cfg["vocab"], (1, 129),
                                               dtype=np.int32)
    loss, grads = jax.value_and_grad(jllama.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(cfg=cfg, tokens=torch.from_numpy(tokens),
                state=llama.params_from_jax(np_tree(jparams)),
                loss=float(loss), grads={
                    n: g.numpy() for n, g in
                    llama.params_from_jax(np_tree(grads)).items()})


def test_llama_loss_and_grads_match_jax(llama_case):
    """Loss to 1e-5 relative, every gradient leaf to 1e-4 of its max-abs
    (as tests/test_torch_train.py)."""
    model = llama.Llama(llama.LlamaConfig(**llama_case["cfg"]), device="cpu")
    model.load_state_dict(llama_case["state"])
    model.requires_grad_(True)
    loss = llama.loss_fn(model, llama_case["tokens"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), llama_case["loss"], rtol=1e-5)
    for name, p in model.named_parameters():
        ref = llama_case["grads"][name]
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"


def _spy(monkeypatch):
    calls = []
    for name in ("flash_attention", "flash_attention_packed",
                 "flash_attention_padded"):
        real = getattr(fa, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(fa, name, spy)
    return calls


@pytest.mark.parametrize("hd,heads,want", [
    (64, 2, "flash_attention"), (128, 2, "flash_attention"),
    (32, 4, "flash_attention_packed"), (32, 2, "flash_attention_padded"),
    (96, 2, "flash_attention_padded"), (80, 2, "flash_attention_padded")])
@pytest.mark.parametrize("model", ["llama", "transformer"])
def test_models_route_by_head_dim(monkeypatch, model, hd, heads, want):
    """As cubecl_tpu/models/llama.py:163-184 and transformer.py:192-214;
    ``kernels=False`` takes the plain version whatever the head dim."""
    calls = _spy(monkeypatch)
    torch.manual_seed(0)
    tokens = torch.randint(0, 32, (1, 128))
    if model == "llama":
        m = llama.init_params(llama.LlamaConfig(
            vocab=32, d_model=hd * heads, n_heads=heads, n_kv_heads=1,
            n_layers=1, d_ff=64, seq=128, use_framework_kernels=False),
            device="cpu")
        out = llama.forward(m, tokens)
        ref = llama.forward(m, tokens, kernels=False)
    else:
        m = transformer.init_params(transformer.TransformerConfig(
            vocab=32, d_model=hd * heads, n_heads=heads, n_layers=1,
            d_ff=64, seq=128, use_framework_kernels=False), device="cpu")
        out = transformer.forward(m, tokens)
        ref = transformer.forward(m, tokens, kernels=False)
    assert calls == [want]
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)


def test_attention_example_twin():
    """``cubecl_tpu_torch/examples/attention.py`` on the CPU against the
    JAX example's four calls on the same inputs (interpret mode)."""
    from cubecl_tpu.ops.paged_attention import paged_attention
    from cubecl_tpu_torch.examples import attention as ex

    got = ex.launch(device="cpu")
    x = {n: jnp.asarray(t.numpy()) for n, t in ex.inputs("cpu").items()}
    q, k, v = x["q"], x["k"], x["v"]
    blk = ex.BLOCK
    dq, dk, dv = jax.grad(lambda q, k, v: jnp.sum(J.flash_attention(
        q, k, v, True, None, blk, blk, True) ** 2), (0, 1, 2))(q, k, v)
    bm = ex.global_band_mask(ex.S // blk)
    want = dict(
        dq=dq, dk=dk, dv=dv,
        local=J.flash_attention_local(q, k, v, 128, 0, True, None, blk, blk,
                                      True),
        block_sparse=J.flash_attention_block_sparse(q, k, v, bm, True, None,
                                                    blk, blk, True),
        block_sparse_dq=jax.grad(lambda q: jnp.sum(
            J.flash_attention_block_sparse(q, k, v, bm, True, None, blk,
                                           blk, True)))(q),
        paged=paged_attention(x["q_decode"], x["k_pages"][0],
                              x["v_pages"][0], x["table"], x["lengths"],
                              interpret=True))
    assert got.keys() == want.keys()
    for name, ref in want.items():
        tol = FWD if name in ("local", "block_sparse", "paged") else GRAD
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref),
                                   **tol, err_msg=name)
