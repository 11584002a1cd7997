"""The f32 flash bodies' arithmetic (csrc/flash_tf32.cuh: the forward's
flash_fwd_tf32x3_kernel and the dK/dV's flash_bwd_dkv_tf32x3_kernel)
emulated in torch on the CPU and held against the JAX package's
``flash_attention`` and its ``jax.vjp``, in Pallas interpret mode under
``jax.jit`` as tests/test_torch_train256.py runs them (at the JAX
function's default blocks, one tile below S 4096: at 128-row blocks S 1021
takes minutes in interpret mode).

The emulation is the kernels' own: every product of f32 operands is three
TF32 products (each operand split by bit masks into big = x truncated to
tf32 and small = tf32(x - big), as csrc/hopper.cuh's tf32_split; A_small
B_big + A_big B_small + A_big B_big, products of tf32 values exact in f32),
each 32 terms of a reduction summed from zero and then added in f32: the
score products panel by panel (32 columns of D), the products over keys
or q rows a step of 32 at a time, the kv tiles walked in steps of 32 keys
with the kernels' online softmax (base 2, the l == 0 and m == -inf
guards). dK and dV sum each step's part over the group's query heads in
the kernels' order. The kernels' layout (the transposed tiles' kperm
order against the accumulator's RS fragments) is held by index
arithmetic. On the card the kernels are held to the plain versions by
tests/test_torch_cuda.py; here f32's tolerance (atol 2e-5, rtol 1e-4)
holds against JAX, and one TF32 product misses it where q and k are large.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import attention as J

F32_TOL = dict(atol=2e-5, rtol=1e-4)
STEP = 32    # keys (forward) or q rows (dK/dV) a step of the kernels
PANEL = 32   # columns of D a score product's part sums
LOG2E = 1.4426950408889634
KEEP = -8192  # 0xffffe000 as int32: sign, exponent and 10 mantissa bits


def split(x):
    """big = x truncated to tf32, small = tf32(x - big) rounded to nearest
    (ties away), as the kernels' ``halves`` (finite x)."""
    big = (x.view(torch.int32) & KEEP).view(torch.float32)
    d = (x - big).view(torch.int32)
    return big, ((d + 0x1000) & KEEP).view(torch.float32)


def mm3(a, b, products=3):
    """a @ b (f32, the reduction 32 terms or fewer) as the kernels' TF32
    products: three (A_small B_big + A_big B_small + A_big B_big), or
    one (A_big B_big)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    if products == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def scores(a, b, products=3):
    """a @ b^T over D, each panel of 32 columns' part summed from zero and
    added in f32."""
    s = None
    for p in range(0, a.shape[-1], PANEL):
        part = mm3(a[..., p:p + PANEL], b[..., p:p + PANEL].transpose(-1, -2),
                   products)
        s = part if s is None else s + part
    return s


def _live(rows, cols, Skv, causal):
    ok = cols[None, :] < Skv
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])
    return ok


def emu_forward(q, k, v, causal, products=3):
    """o and the base-2 lse of flash_fwd_tf32x3_kernel: q (B, H, Sq, D),
    k, v (B, Hkv, Skv, D) f32."""
    B, H, Sq, D = q.shape
    rep = H // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    Skv = k.shape[2]
    scale_log2 = np.float32(D ** -0.5 * LOG2E)
    rows = torch.arange(Sq)
    m = torch.full((B, H, Sq), -torch.inf)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Skv, STEP):
        kk, vv = k[:, :, k0:k0 + STEP], v[:, :, k0:k0 + STEP]
        cols = torch.arange(k0, k0 + kk.shape[2])
        s = scores(q, kk, products)
        ok = _live(rows, cols, Skv, causal)
        s = torch.where(ok, s * scale_log2, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        acc = acc * alpha[..., None] + mm3(p, vv, products)
    inv = torch.where(l == 0, 1.0, 1.0 / l)
    lse = torch.where(l == 0, 0.0, m + torch.log2(l))
    return acc * inv[..., None], lse


def emu_dkv(q, k, v, do, o, lse, causal):
    """dk, dv of flash_bwd_dkv_tf32x3_kernel on the forward's o and lse:
    the transposed scores and dP^T by panels, p^T and dS^T in f32, dV +=
    p^T dO and dK += dS^T q a step of 32 q rows at a time, each step's
    part added, the query heads of a kv head's group in order."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = np.float32(D ** -0.5)
    scale_log2 = np.float32(D ** -0.5 * LOG2E)
    di = (do * o).sum(-1)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    keys = torch.arange(Skv)
    for hk in range(Hkv):
        kh, vh = k[:, hk], v[:, hk]
        for g in range(rep):
            h = hk * rep + g
            for q0 in range(0, Sq, STEP):
                sl = slice(q0, q0 + STEP)
                qs, dos = q[:, h, sl], do[:, h, sl]
                rows = torch.arange(q0, q0 + qs.shape[1])
                st = scores(kh, qs)   # (B, Skv, step): keys x q rows
                dpt = scores(vh, dos)
                ok = _live(rows, keys, Skv, causal).transpose(0, 1)
                pt = torch.where(ok, torch.exp2(
                    st * scale_log2 - lse[:, h, None, sl]), 0.0)
                dst = pt * (dpt - di[:, h, None, sl]) * scale
                dv[:, hk] += mm3(pt, dos)
                dk[:, hk] += mm3(dst, qs)
    return dk, dv


def _inputs(seed, H, Hkv, S, D, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, S, D), dtype=np.float32) * np.float32(scale)
    k = rng.standard_normal((1, Hkv, S, D), dtype=np.float32) * np.float32(scale)
    v = rng.standard_normal((1, Hkv, S, D), dtype=np.float32)
    do = rng.standard_normal((1, H, S, D), dtype=np.float32)
    return q, k, v, do


@functools.lru_cache(maxsize=None)
def _jax_ref(D, causal, G, S, scale=1.0):
    """o and (dq, dk, dv) of the JAX flash_attention (A1, A3, A4 in
    interpret mode) by jax.vjp under jit, the kv heads repeated to H as the
    JAX models feed them (dk, dv summed back over each group)."""
    q, k, v, do = _inputs(D + S + G, 3, 3 // G, S, D, scale)

    def f(q, k, v):
        return J.flash_attention(q, jnp.repeat(k, G, axis=1),
                                 jnp.repeat(v, G, axis=1), causal, None, None,
                                 None, True)

    def both(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(do)

    o, grads = jax.jit(both)(*(jnp.asarray(a) for a in (q, k, v, do)))
    return (q, k, v, do), np.asarray(o), [np.asarray(x) for x in grads]


# D 64, 128 and 256 at S 1021 (ragged: 31 steps and a step of 29), causal
# on 3 query heads a kv head and full on one
CASES = [(D, causal, G) for D in (64, 128, 256)
         for causal, G in ((True, 3), (False, 1))]
S = 1021


def _ids(c):
    return f"D{c[0]}-{'causal' if c[1] else 'full'}-G{c[2]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_emulation_matches_jax(case):
    """o of the 3xTF32 forward's arithmetic against JAX A1 at f32's
    tolerance; the lse against the JAX-free exact f64 one."""
    D, causal, G = case
    (q, k, v, _), o_ref, _ = _jax_ref(D, causal, G, S)
    o, lse = emu_forward(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), o_ref, **F32_TOL)
    q64, k64 = (torch.from_numpy(a).double() for a in (q, k))
    s = q64 @ k64.repeat_interleave(G, 1).transpose(-1, -2) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          -torch.inf)
    lse64 = torch.logsumexp(s, -1) * LOG2E
    np.testing.assert_allclose(lse.numpy(), lse64.numpy(), **F32_TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_dkv_emulation_matches_jax_grad(case):
    """dk and dv of the 3xTF32 dK/dV's arithmetic, on the emulated
    forward's o and lse, against the JAX vjp (A3) at f32's tolerance."""
    D, causal, G = case
    (q, k, v, do), _, (_, dk_ref, dv_ref) = _jax_ref(D, causal, G, S)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = emu_forward(q, k, v, causal)
    dk, dv = emu_dkv(q, k, v, do, o, lse, causal)
    np.testing.assert_allclose(dk.numpy(), dk_ref, **F32_TOL, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), dv_ref, **F32_TOL, err_msg="dv")


# q and k scaled up: scores of a few tens, where the softmax magnifies an
# error of the scores
LARGE = dict(D=64, causal=True, G=1, S=256, scale=2.0)


def test_one_tf32_product_misses_f32_where_three_hold():
    """Why the f32 bodies issue three TF32 products: with large q and k
    (N(0, 4) entries, D 64, S 256 causal), one TF32 product (A_big B_big)
    puts o outside f32's tolerance of JAX A1, three keep it inside."""
    (q, k, v, _), o_ref, _ = _jax_ref(**LARGE)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    three, _ = emu_forward(*args, LARGE["causal"])
    one, _ = emu_forward(*args, LARGE["causal"], products=1)
    np.testing.assert_allclose(three.numpy(), o_ref, **F32_TOL)
    lim = F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(o_ref)
    assert np.sum(np.abs(one.numpy() - o_ref) > lim) > 0.01 * o_ref.size


def test_split_halves_sum_to_x():
    """big + small is x to 2^-21 of |x|, both of x's sign (the cross terms
    of a product drop only A_small B_small)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        100000, dtype=np.float32) * 1e3)
    big, small = split(x)
    assert torch.all((x.double() - big.double() - small.double()).abs()
                     <= 2.0 ** -21 * x.double().abs())
    assert torch.all(big.abs() <= x.abs()) and torch.all(small * x >= 0)
    for t in (big, small):  # tf32 values: the 13 low bits clear
        assert torch.all(t.view(torch.int32) & 0x1FFF == 0)


def test_transposed_tile_pairs_the_accumulator_columns():
    """The RS fragment of k8 slice kk that acc_frag takes from an m64n32
    accumulator holds, for thread t of a quad, columns 8 kk + 2t and
    8 kk + 2t + 1 as the fragment's k = t and t + 4; stage_cols stores
    row 8a + j of the step at position 8a + kperm(j) of the transposed
    tile. The wgmma sums A[m][k] B[k][n] over k, so row j of the step
    meets column j of the accumulator for every j: the product is x @ y."""
    def kperm(j):
        return (j >> 1) | ((j & 1) << 2)

    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 32))   # the accumulator: rows x steps
    y = rng.standard_normal((32, 64))   # the step's rows x columns
    tile = np.zeros((64, 32))           # stage_cols: columns x positions
    for r in range(32):
        tile[:, (r & ~7) | kperm(r & 7)] = y[r]
    got = np.zeros((64, 64))
    for kk in range(4):
        a = np.zeros((64, 8))
        for t in range(4):  # acc_frag: x[4kk + {0, 2, 1, 3}] by quad lane t
            a[:, t] = x[:, 8 * kk + 2 * t]
            a[:, t + 4] = x[:, 8 * kk + 2 * t + 1]
        got += a @ tile[:, 8 * kk:8 * kk + 8].T
    np.testing.assert_allclose(got, x @ y, rtol=1e-12, atol=1e-12)
