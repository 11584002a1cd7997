"""Head dim 256 (GPT-J-6B's, Qwen3-Next's) in cubecl_tpu_torch against
cubecl_tpu: A1's forward (``flash_attention`` with its lse, the padded
route from D 192, the masked options), P1 in every mode on f32, bf16 and
int8 pools at 1, 8 and 12 query heads a kv head, P3, both launch plans at
D 256, the refusal of a training pass past 256 (training at 256 is
tests/test_torch_train256.py's), and
the llama at head dim 256 served through ``prefill``, ``decode_step``,
``decode_chunk``, ``prefill_chunked`` and greedy ``generate``.

The port runs its plain versions on these CPU tensors (on the card D 256
launches the D 256 instances of csrc/flash_attention.cu,
csrc/paged_attention.cu and csrc/paged_chunked.cu, held to the plain
versions by tests/test_torch_cuda.py); the JAX kernels run in Pallas
interpret mode. f32 tolerances, summation order only: atol 2e-5 / rtol
1e-4 for the kernels, atol 3e-5 / rtol 1e-4 for the model's logits
(tests/test_torch_serving.py's). bf16 pools and q given to both sides as
the same values: both compute in f32 and round the output to bf16 once,
so one bf16 ulp apart (atol / rtol 1e-2). int8 pools given to both sides
as the same values and scales take the f32 tolerance. Greedy tokens
equal.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.ops import attention as fa
from cubecl_tpu_torch.ops.paged_attention import (
    PAGED_HEAD_DIMS,
    p1_plan,
    p3_plan,
    paged_attention,
    paged_attention_chunked,
    quantize_kv,
)

jax_attention = importlib.import_module("cubecl_tpu.ops.attention")
jax_paged = importlib.import_module("cubecl_tpu.ops.paged_attention")

ATOL, RTOL = 2e-5, 1e-4
BF16_TOL = 1e-2
LOGIT_ATOL, LOGIT_RTOL = 3e-5, 1e-4
D = 256
BLK = 128  # the JAX flash kernels' blocks in interpret mode
SMEM_LIMIT = 232448  # shared memory a block may use on the H100


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _qkv(seed, B, H, Hkv, S, Dq=D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, h, S, Dq), dtype=np.float32)
                 for h in (H, Hkv, Hkv))


def _rep(a, rep):
    """kv heads repeated to the query heads, as the JAX models feed them."""
    return np.repeat(a, rep, axis=1) if rep > 1 else a


# -- A1's forward -------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_forward_and_lse_match_jax_kernel(causal):
    """flash_attention at D 256 (GQA 2 on 1, S 128) and the base-2 lse the
    training forward keeps, against A1's output and residual."""
    q, k, v = _qkv(1 + causal, 1, 2, 1, 128)
    ref_o, ref_lse = jax_attention._fwd_call(
        jnp.asarray(q), jnp.asarray(_rep(k, 2)), jnp.asarray(_rep(v, 2)),
        causal, D ** -0.5, BLK, BLK, True)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_o), atol=ATOL,
                               rtol=RTOL)
    _, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), causal,
                                      return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("Dq", [192, 160])
def test_flash_padded_matches_jax_kernel(Dq):
    """flash_attention_padded past 128 (padded to 256, the scale from the
    real D) at a ragged S against the JAX function, which pads D to 256
    for its exact kernel."""
    q, k, v = _qkv(Dq, 1, 2, 2, 100, Dq)
    ref = jax_attention.flash_attention_padded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, block_q=BLK,
        block_k=BLK, interpret=True)
    got = fa.flash_attention_padded(_t(q), _t(k), _t(v))
    assert got.shape == (1, 2, 100, Dq)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("option", ["kv_len", "window"])
def test_flash_options_match_jax_kernel(option):
    """A1's options at D 256: keys past kv_len absent, and a sliding window
    (flash_attention_local, left 40), against the JAX functions."""
    q, k, v = _qkv(7, 1, 2, 2, 128)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if option == "kv_len":
        ref = jax_attention.flash_attention(jq, jk, jv, True, block_q=BLK,
                                            block_k=BLK, interpret=True,
                                            kv_len=100)
        got = fa.flash_attention(_t(q), _t(k), _t(v), kv_len=100)
    else:
        ref = jax_attention.flash_attention_local(jq, jk, jv, 40, block_q=BLK,
                                                  block_k=BLK, interpret=True)
        got = fa.flash_attention_local(_t(q), _t(k), _t(v), 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_flash_routes_head_dim_256_to_the_exact_kernel():
    """The models' flash function at D 256 is flash_attention, whose
    forward and backward have D 256 instances (as the block-sparse ones
    have)."""
    assert fa.flash_for_head_dim(D, 16) is fa.flash_attention
    assert fa.KERNEL_HEAD_DIMS == (64, 128, 256)
    assert fa.SPARSE_HEAD_DIMS == (64, 128, 256)


@pytest.mark.parametrize("Dq", [160, 256])
def test_flash_refuses_a_training_pass_off_the_cpu(Dq):
    """Off the CPU (meta tensors stand in for the card's) a pass under
    grad is refused only past 256, naming ROADMAP Queue 2a: at Dq (padded
    to 256, or 256) it goes on to the kernels, which want a CUDA tensor;
    at Dq + 256 it is refused before any launch. The CPU trains on the
    plain versions at both, with gradients."""
    for d, err, match in ((Dq, ValueError, "CUDA"),
                          (Dq + 256, NotImplementedError, "Queue 2a")):
        q = torch.zeros(1, 2, 64, d, device="meta", requires_grad=True)
        with pytest.raises(err, match=match):
            fa.flash_attention_padded(q, q, q)
        x = torch.from_numpy(_qkv(3, 1, 2, 2, 64, d)[0]).requires_grad_()
        fa.flash_attention_padded(x, x, x).sum().backward()
        assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_flash_past_256_stays_unported():
    """D 288 has no padded instance: it runs unpadded on the CPU and
    raises off it."""
    q = torch.zeros(1, 1, 64, 288, device="meta")
    with pytest.raises(NotImplementedError, match="256"):
        fa.flash_attention_padded(q, q, q)
    x = torch.from_numpy(_qkv(4, 1, 1, 1, 40, 288)[0])
    torch.testing.assert_close(fa.flash_attention_padded(x, x, x),
                               fa.flash_attention_plain(x, x, x))


# -- P1 -----------------------------------------------------------------------

HKV, L, P, PAGE, MAX_PAGES = 2, 2, 48, 8, 8
# a length-0 row, mid-page, the full capacity, one position, past a tile
LENGTHS = np.array([0, 13, 64, 1, 41], np.int32)
NB = len(LENGTHS)


@pytest.fixture(scope="module")
def pools():
    """f32 pools, bf16 ones (the same values rounded), int8 ones with their
    scales (quantize_kv of the f32 ones), and a table whose rows own
    disjoint pages (as a ring's do)."""
    rng = np.random.default_rng(256)
    kp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    vp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    (k8, ks), (v8, vs) = (quantize_kv(torch.from_numpy(x)) for x in (kp, vp))
    table = rng.permutation(P)[:NB * MAX_PAGES].reshape(NB, MAX_PAGES)
    bf = tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (kp, vp))
    return dict(f32=(kp, vp, None, None),
                bf16=(*bf, None, None),
                int8=tuple(t.numpy() for t in (k8, v8, ks, vs)),
                table=table.astype(np.int32))


def _ring_meta(table, lengths, capacity, sinks):
    """pos_meta of a ring that decoded each row token by token."""
    meta = np.full((P, PAGE), -1, np.int32)
    for b, n in enumerate(lengths):
        for t in range(n):
            j = t if t < sinks else sinks + (t - sinks) % (capacity - sinks)
            meta[table[b, j // PAGE], j % PAGE] = t
    return meta


def _as_jax(x):
    """A torch bf16 tensor as a JAX bf16 array (bit for bit), else numpy."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)
    return _j(x.numpy() if isinstance(x, torch.Tensor) else x)


# every mode on every pool kind, the three groups spread over both
P1_CASES = [("full", "f32", 1), ("full", "bf16", 8), ("full", "int8", 12),
            ("window", "f32", 8), ("window", "bf16", 12),
            ("window", "int8", 1), ("ring", "f32", 12), ("ring", "bf16", 1),
            ("ring", "int8", 8)]


@pytest.mark.parametrize("mode,kv,G", P1_CASES,
                         ids=[f"{m}-{k}-G{g}" for m, k, g in P1_CASES])
def test_decode_matches_jax_kernel(pools, mode, kv, G):
    """P1 at D 256: every position below the length (layer 1 of the
    stacked pools), window + sinks (a window that starts inside a tile,
    sinks inside a page), the ring (recycled slots, sinks 8, window 40 on
    64 slots, layer 1's pool on the JAX side), at G 1, 8 and 12 (past 8:
    the port's row groups) on f32, bf16 and int8 pools; a row with no live
    position gets zeros."""
    kp, vp, ks, vs = pools[kv]
    qf = np.random.default_rng(G).standard_normal((NB, HKV * G, D),
                                                  dtype=np.float32)
    q = torch.from_numpy(qf)
    if kv == "bf16":
        q = q.to(torch.bfloat16)
    lengths = LENGTHS if mode != "ring" else np.array([0, 70, 65, 1, 130],
                                                      np.int32)
    kw, jkw = {}, dict(layer=1)
    if mode == "window":
        kw = jkw = dict(window=20, sinks=9)
        jkw = dict(jkw, layer=1)
    elif mode == "ring":
        meta = _ring_meta(pools["table"], lengths, PAGE * MAX_PAGES, 8)
        kw = dict(window=40, sinks=8, pos_meta=torch.from_numpy(meta))
        jkw = dict(window=40, sinks=8, pos_meta=jnp.asarray(meta))
    jk, jv = (_as_jax(x) for x in (kp, vp))
    jks, jvs = _j(ks), _j(vs)
    if mode == "ring":
        jk, jv = jk[1], jv[1]
        jks, jvs = (None, None) if ks is None else (jks[1], jvs[1])
    ref = np.asarray(jax_paged.paged_attention(
        _as_jax(q), jk, jv, _j(pools["table"]), _j(lengths), k_scales=jks,
        v_scales=jvs, interpret=True, **jkw).astype(jnp.float32))
    got = paged_attention(q, _t(kp) if kv != "bf16" else kp,
                          _t(vp) if kv != "bf16" else vp,
                          _t(pools["table"]), _t(lengths), layer=1,
                          k_scales=_t(ks), v_scales=_t(vs), **kw)
    assert got.shape == (NB, HKV * G, D) and got.dtype == q.dtype
    tol = BF16_TOL if kv == "bf16" else None
    live = lengths > 0
    np.testing.assert_allclose(got.float().numpy()[live], ref[live],
                               atol=tol or ATOL, rtol=tol or RTOL)
    assert not got[~torch.from_numpy(live)].any()


# -- P3 -----------------------------------------------------------------------

STARTS = np.array([0, 5, 8, 13, 30], np.int32)


@pytest.mark.parametrize("kv, G, C", [("f32", 2, 5), ("int8", 8, 5),
                                      ("bf16", 1, 16), ("f32", 12, 3)],
                         ids=["verify-f32-G2", "verify-int8-G8",
                              "prefill-bf16-C16", "G12-f32-C3"])
def test_chunked_matches_jax_kernel(pools, kv, G, C):
    """P3 at D 256: decode-shaped (the verify step's C 5) and
    prefill-shaped chunks, from 0, in mid-page, on a page boundary and
    after a prefix, lengths = starts + C, layer 1, on each pool kind."""
    kp, vp, ks, vs = pools[kv]
    q = torch.from_numpy(np.random.default_rng(10 * C + G).standard_normal(
        (NB, HKV * G, C, D), dtype=np.float32))
    if kv == "bf16":
        q = q.to(torch.bfloat16)
    lengths = STARTS + C
    ref = jax_paged.paged_attention_chunked(
        _as_jax(q), _as_jax(kp), _as_jax(vp), _j(pools["table"]),
        _j(lengths), _j(STARTS), interpret=True, k_scales=_j(ks),
        v_scales=_j(vs), layer=1)
    got = paged_attention_chunked(
        q, kp if kv == "bf16" else _t(kp), vp if kv == "bf16" else _t(vp),
        _t(pools["table"]), _t(lengths), _t(STARTS), layer=1,
        k_scales=_t(ks), v_scales=_t(vs))
    assert got.shape == (NB, HKV * G, C, D)
    tol = BF16_TOL if kv == "bf16" else None
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol or ATOL, rtol=tol or RTOL)


# -- the launch plans at D 256 -----------------------------------------------

# P1's shared memory at D 256 (csrc P1Smem): q (8 rows x 256 f32) and the
# 8 warps' rings of 8 K and 8 V rows a stage (int8: their scales; the
# ring: the positions' meta), 3 stages (f32 pools: 1)
P1_SMEM = {("bf16", "full"): 8192 + 8 * 3 * 8192,
           ("bf16", "ring"): 8192 + 8 * 3 * (8192 + 32),
           ("int8", "full"): 8192 + 8 * 3 * (4096 + 64),
           ("int8", "ring"): 8192 + 8 * 3 * (4096 + 64 + 32),
           ("f32", "full"): 8192 + 8 * 1 * 16384,
           ("f32", "ring"): 8192 + 8 * 1 * (16384 + 32)}
KINDS = {"bf16": (torch.bfloat16, torch.bfloat16),
         "int8": (torch.bfloat16, torch.int8),
         "f32": (torch.float32, torch.float32)}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("mode", ["full", "window", "ring"])
@pytest.mark.parametrize("G", [1, 8, 12])
def test_p1_plan_at_d256_fits_the_card(kind, mode, G):
    """p1_plan at D 256: every instance's shared memory under the 232,448
    bytes a block may use, the stages as csrc/paged_attention.cu states
    them (1 for f32 pools, whose 16 KB stages would not fit three a warp,
    else 3), one block an SM for the splits (the kernels are built for
    one), the row groups past 8 query heads a kv head."""
    dt, kv = KINDS[kind]
    window, sinks = (512, 4) if mode != "full" else (0, 0)
    plan = p1_plan(dt, kv, 8, 16 * G, 16, D, 128, 9, window, sinks,
                   mode == "ring")
    assert plan.smem_bytes == P1_SMEM[kind, "ring" if mode == "ring"
                                      else "full"]
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.stages == (1 if kind == "f32" else 3)
    assert plan.groups == (2 if G > 8 else 1)
    # 8 x 16 kv heads x groups: 128 or 256 blocks hold one wave at one an
    # SM without a split; one batch row splits to fill 132 SMs once
    assert plan.splits == 1
    one = p1_plan(dt, kv, 1, 16 * G, 16, D, 128, 9, window, sinks,
                  mode == "ring")
    assert one.splits == 132 // (16 * one.groups)
    assert one.scratch == 16 * G * one.splits * (D + 2)


@pytest.mark.parametrize("kind", list(KINDS))
def test_p3_plan_at_d256_fits_the_card(kind):
    """p3_plan at D 256: the bf16 body's four 64-column panels a tile and 3
    stages (230,400 bytes with bf16 pools, 199,168 with int8: one block an
    SM), the f32 body's tiles (214,528); under 232,448 bytes."""
    dt, kv = KINDS[kind]
    plan = p3_plan(dt, kv, 8, 16, 16, 5, D, 128, 9)
    want = {"bf16": 32768 + 3 * 2 * 32768 + 1024,
            "int8": 32768 + 3 * 2 * 64 * 256 + 2 * 32768 + 3 * 2 * 64 * 4
            + 1024,
            "f32": (D * 64 * 3 + 64 * 68 + 2 * 64) * 4}[kind]
    assert plan.smem_bytes == want <= SMEM_LIMIT
    assert plan.body == ("cuda-cores" if kind == "f32" else "wgmma")
    assert 256 in PAGED_HEAD_DIMS


# -- the llama at head dim 256 ------------------------------------------------

HD256 = dict(vocab=64, d_model=512, n_heads=2, n_kv_heads=1, n_layers=2,
             d_ff=128, seq=64, use_flash_attention=False,
             use_framework_kernels=False)


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port model) on the same weights; the port
    prefills through its flash route (flash_for_head_dim(256), the plain
    version on the CPU), the JAX llama through its plain attention (its
    flash kernel has no interpret flag there)."""
    jcfg = jllama.LlamaConfig(**HD256)
    jparams = jllama.init_params(jcfg, seed=41)
    model = llama.Llama(llama.LlamaConfig(**dict(
        HD256, use_flash_attention=True)), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    assert model.cfg.head_dim == 256
    return jcfg, jparams, model


def test_llama_prefill_and_decode_steps_match_jax(pair):
    """prefill of a 12-token prompt, then 6 decode steps fed the JAX
    steps' greedy tokens: logits, pools and lengths against the JAX
    package's; the greedy tokens equal."""
    jcfg, jparams, model = pair
    Bq, page = 2, 16
    prompt = np.random.RandomState(42).randint(0, 64, (Bq, 12)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    jl, jc = jllama.prefill(jparams, jc, jnp.asarray(prompt), jcfg)
    c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    lg, c = llama.prefill(model, c, torch.from_numpy(prompt))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    jstep = jax.jit(lambda p, c_, t: jllama.decode_step(p, c_, t, jcfg))
    tok, jls, toks = jnp.argmax(jl, -1).astype(jnp.int32), [], []
    for _ in range(6):
        toks.append(np.asarray(tok))
        jl, jc = jstep(jparams, jc, tok)
        jls.append(np.asarray(jl))
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    got = []
    for t in toks:
        lg, c = llama.decode_step(model, c, torch.from_numpy(t))
        got.append(lg.numpy())
    got, ref = np.stack(got, 1), np.stack(jls, 1)
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc[name]), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(c.lengths.numpy(),
                                  np.asarray(jc["lengths"]))


def test_llama_decode_chunk_and_prefill_chunked_match_jax(pair):
    """decode_chunk of 5 tokens (the verify step) after a 9-token prefill,
    and prefill_chunked in chunks of 8 over S 21 (a ragged last chunk),
    against the JAX package's."""
    jcfg, jparams, model = pair
    Bq, page = 2, 16
    toks = np.random.RandomState(43).randint(0, 64, (Bq, 21)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    _, jc = jllama.prefill(jparams, jc, jnp.asarray(toks[:, :9]), jcfg)
    jl, jc = jllama.decode_chunk(jparams, jc, jnp.asarray(toks[:, 9:14]),
                                 jcfg)
    c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    _, c = llama.prefill(model, c, torch.from_numpy(toks[:, :9]))
    lg, c = llama.decode_chunk(model, c, torch.from_numpy(toks[:, 9:14]))
    assert lg.shape == (Bq, 5, 64)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(c.lengths.numpy(),
                                  np.asarray(jc["lengths"]))
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    jl, jc = jllama.prefill_chunked(jparams, jc, jnp.asarray(toks), jcfg,
                                    chunk=8)
    c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    lg, c = llama.prefill_chunked(model, c, torch.from_numpy(toks), chunk=8)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc[name]), atol=LOGIT_ATOL)


def test_llama_generate_matches_jax(pair):
    """Greedy generate, 6 tokens after a 7-token prompt: the port's tokens
    equal the JAX package's."""
    jcfg, jparams, model = pair
    prompt = np.random.RandomState(44).randint(0, 64, (2, 7)).astype(
        np.int32)
    ref = jllama.generate(jparams, jnp.asarray(prompt), 6, jcfg,
                          max_pages=2)
    got = llama.generate(model, torch.from_numpy(prompt), 6, max_pages=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert math.isfinite(float(got.float().sum()))
