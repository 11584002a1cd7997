"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without a CUDA device (as the CPU
test run) and run on the H100 with

    python -m pytest -o addopts="" -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(``-o addopts=""`` drops the JAX package's pytest plugin: the card's host
has no JAX). Tolerances: f32 atol 2e-5 / rtol 1e-4 (summation order only);
bf16 atol 1e-2 / rtol 1e-2, one bf16 rounding (2^-8 relative) of the
output apart.
"""

import numpy as np
import pytest
import torch

from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_plain,
)
from cubecl_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    atol, rtol = TOL[ref.dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 77, 200])
def test_flash_kernel_matches_plain(dev, dtype, D, causal, S):
    g = torch.Generator(device=dev).manual_seed(S + D)
    q = torch.randn(2, 6, S, D, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 2, S, D, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 2, S, D, generator=g, device=dev).to(dtype)
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    _close(got, flash_attention_plain(q, k, v, causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_paged_kernel_matches_plain(dev, dtype, D, G):
    g = torch.Generator(device=dev).manual_seed(G * D)
    B, Hkv, L, page, max_pages = 6, 2, 3, 16, 5
    P = B * max_pages + 3
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(dtype)
    kp = torch.randn(L, Hkv, P, page, D, generator=g, device=dev).to(dtype)
    vp = torch.randn(L, Hkv, P, page, D, generator=g, device=dev).to(dtype)
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages]
    table = table.view(B, max_pages).to(torch.int32)
    lengths = torch.tensor([0, 1, 15, 16, 17, 80], dtype=torch.int32,
                           device=dev)
    n = paged_attention.launches
    got = paged_attention(q, kp, vp, table, lengths, layer=2)
    torch.cuda.synchronize()
    assert paged_attention.launches == n + 1
    _close(got, paged_attention_plain(q, kp, vp, table, lengths, layer=2))
    assert not got[0].any()


def test_generate_kernels_match_plain(dev):
    cfg = llama.LlamaConfig(vocab=128, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512,
                            use_framework_kernels=False)
    model = llama.init_params(cfg, seed=0, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 70), dtype=np.int32)).to(dev)
    got = llama.generate(model, prompt, 8, max_pages=3, page=32)
    ref = llama.generate(model, prompt, 8, max_pages=3, page=32,
                         kernels=False)
    assert torch.equal(got, ref)
