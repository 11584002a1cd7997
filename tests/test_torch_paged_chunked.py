"""cubecl_tpu_torch.ops.paged_attention's chunked attention (P3), int8 KV
in decode attention (P1) and ``quantize_kv``, against cubecl_tpu's.

The port's functions run their plain versions on these CPU tensors; the
JAX kernels run in Pallas interpret mode. Stacked pools of 3 layers read
at layer 2 (layer 1 for int8), page 8, 4 rows whose chunks start at 0, in
mid-page, on a page boundary and in mid-page again, so that the lengths
(start + C, as P3 requires) are ragged. f32 inputs, atol 1e-5 / rtol 1e-4:
the two sides sum in different orders.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_chunked,
    paged_attention_chunked_plain,
    paged_attention_plain,
    quantize_kv,
)

jax_paged = importlib.import_module("cubecl_tpu.ops.paged_attention")

ATOL, RTOL = 1e-5, 1e-4
B, HKV, D = 4, 2, 64
L, P, PAGE, MAX_PAGES = 3, 24, 8, 4
STARTS = np.array([0, 5, 8, 13], np.int32)


def _pools(rng, quant):
    """(k, v, k_scales, v_scales) as numpy: f32 pools, or int8 pools with
    positive f32 scales of the size quantize_kv gives N(0, 1) rows."""
    shape = (L, HKV, P, PAGE, D)
    if not quant:
        return (rng.standard_normal(shape, dtype=np.float32),
                rng.standard_normal(shape, dtype=np.float32), None, None)
    k, v = (rng.integers(-127, 128, shape, dtype=np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.03, shape[:4]).astype(np.float32)
              for _ in range(2))
    return k, v, ks, vs


def _table(rng):
    return np.stack([rng.permutation(P)[:MAX_PAGES]
                     for _ in range(B)]).astype(np.int32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# every pool type meets each G and each C (the full product adds nothing:
# the kernel's rows are g * C + i either way)
@pytest.mark.parametrize("quant, G, C", [
    (False, 1, 1), (False, 2, 5), (False, 2, 16),
    (True, 1, 5), (True, 2, 1), (True, 1, 16)],
    ids=["f32-G1-C1", "f32-G2-C5", "f32-G2-C16", "int8-G1-C5", "int8-G2-C1",
         "int8-G1-C16"])
def test_chunked_matches_jax_kernel(quant, G, C):
    rng = np.random.default_rng(100 * C + 10 * G + quant)
    k, v, ks, vs = _pools(rng, quant)
    q = rng.standard_normal((B, HKV * G, C, D), dtype=np.float32)
    table = _table(rng)
    lengths = STARTS + C
    layer = 1 if quant else 2
    ref = jax_paged.paged_attention_chunked(
        *(jnp.asarray(a) for a in (q, k, v, table, lengths, STARTS)),
        interpret=True, k_scales=_j(ks), v_scales=_j(vs), layer=layer)
    got = paged_attention_chunked(
        *(torch.from_numpy(a) for a in (q, k, v, table, lengths, STARTS)),
        layer=layer, k_scales=_t(ks), v_scales=_t(vs))
    assert got.shape == (B, HKV * G, C, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_chunked_masks_lengths_and_empty_rows():
    """The port also masks t < lengths (P3 assumes lengths = starts + C):
    against a numpy oracle with lengths below starts + C, a row of length
    0 (zeros) and a row whose first tokens see nothing past its length."""
    rng = np.random.default_rng(7)
    C, G = 5, 2
    k, v, _, _ = _pools(rng, False)
    q = rng.standard_normal((B, HKV * G, C, D), dtype=np.float32)
    table = _table(rng)
    starts = np.array([0, 5, 8, 3], np.int32)
    lengths = np.array([0, 7, 13, 30], np.int32)
    got = paged_attention_chunked_plain(
        *(torch.from_numpy(a) for a in (q, k, v, table, lengths, starts)),
        layer=2).numpy()
    assert not got[0].any()
    kc = k[2][:, table].reshape(HKV, B, -1, D)
    vc = v[2][:, table].reshape(HKV, B, -1, D)
    for b in range(1, B):
        for h in range(HKV * G):
            for i in range(C):
                n = min(starts[b] + i + 1, lengths[b])
                s = q[b, h, i] @ kc[h // G, b, :n].T / np.sqrt(D)
                p = np.exp(s - s.max())
                ref = (p / p.sum()) @ vc[h // G, b, :n]
                np.testing.assert_allclose(got[b, h, i], ref, atol=ATOL,
                                           rtol=RTOL)


@pytest.mark.parametrize("dynamic_grid", [True, False], ids=["P2", "P1"])
def test_int8_decode_matches_jax_kernel(dynamic_grid):
    """P1 with int8 pools and scales against the JAX kernel on both of its
    grids; lengths 0, mid-page, a page boundary and the full table."""
    rng = np.random.default_rng(3)
    k, v, ks, vs = _pools(rng, True)
    q = rng.standard_normal((B, 2 * HKV, D), dtype=np.float32)
    table = _table(rng)
    lengths = np.array([0, 13, 16, 32], np.int32)
    ref = jax_paged.paged_attention(
        *(jnp.asarray(a) for a in (q, k, v, table, lengths)),
        interpret=True, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        layer=1, dynamic_grid=dynamic_grid)
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q, k, v, table, lengths)),
                          layer=1, k_scales=_t(ks), v_scales=_t(vs)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert not got[0].any()


def test_quantize_kv_matches_jax():
    """int8 values equal but for +-1 on at most 0.1% of the entries (an f32
    quotient on the other side of .5), scales within 1e-7 relative."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((HKV, P, PAGE, D), dtype=np.float32)
    x[0, 0, 0] = 0.0                                  # amax 0: scale 1
    jq, js = (np.asarray(a) for a in jax_paged.quantize_kv(jnp.asarray(x)))
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-7, atol=0)
    assert s[0, 0, 0] == 1.0 and not q[0, 0, 0].any()
    diff = np.abs(q.numpy().astype(np.int32) - jq.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_quantize_kv_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, s = quantize_kv(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


def test_page_ids_are_clamped():
    """Table entries outside [0, P) read the nearest pool page (the JAX
    scale gather wraps -1 to the last page instead)."""
    rng = np.random.default_rng(9)
    k, v, ks, vs = (torch.from_numpy(a) for a in _pools(rng, True))
    q = torch.from_numpy(rng.standard_normal((1, HKV, D), dtype=np.float32))
    lengths = torch.tensor([2 * PAGE], dtype=torch.int32)
    bad = torch.tensor([[-1, P + 3]], dtype=torch.int32)
    good = torch.tensor([[0, P - 1]], dtype=torch.int32)
    got, want = (paged_attention_plain(q, k, v, t, lengths, layer=0,
                                       k_scales=ks, v_scales=vs)
                 for t in (bad, good))
    assert torch.equal(got, want)


def test_cpu_takes_plain_versions_without_launching():
    rng = np.random.default_rng(1)
    k, v, ks, vs = (torch.from_numpy(a) for a in _pools(rng, True))
    q = torch.from_numpy(rng.standard_normal((B, HKV, 3, D),
                                             dtype=np.float32))
    table = torch.from_numpy(_table(rng))
    starts = torch.from_numpy(STARTS)
    n = (paged_attention_chunked.launches, paged_attention.launches,
         paged_attention.int8_launches)
    args = (q, k, v, table, starts + 3, starts)
    assert torch.equal(
        paged_attention_chunked(*args, layer=1, k_scales=ks, v_scales=vs),
        paged_attention_chunked_plain(*args, layer=1, k_scales=ks,
                                      v_scales=vs))
    paged_attention(q[:, :, 0], k, v, table, starts + 1, k_scales=ks,
                    v_scales=vs)
    assert (paged_attention_chunked.launches, paged_attention.launches,
            paged_attention.int8_launches) == n


def test_other_devices_and_bad_arguments_raise():
    rng = np.random.default_rng(2)
    k, v, ks, vs = (torch.from_numpy(a) for a in _pools(rng, True))
    q = torch.zeros(B, HKV, 2, D)
    table = torch.from_numpy(_table(rng))
    starts = torch.from_numpy(STARTS)
    meta = [t.to("meta") for t in (q, k, v, table, starts + 2, starts, ks,
                                   vs)]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_chunked(*meta[:6], k_scales=meta[6],
                                v_scales=meta[7])
    with pytest.raises(ValueError, match="scales"):
        paged_attention_chunked(q, k, v, table, starts + 2, starts)
    with pytest.raises(ValueError, match="scales"):
        paged_attention(q[:, :, 0], k, v, table, starts, k_scales=ks)
    with pytest.raises(ValueError):
        paged_attention_chunked(q, k, v, table, starts[:2] + 2, starts,
                                k_scales=ks, v_scales=vs)
