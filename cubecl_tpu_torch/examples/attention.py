"""The attention family: dense flash, sliding-window, block-sparse (all
differentiable) and paged-KV decode, the four shapes attention takes in
training and serving. The twin of the JAX package's
``examples/attention.py``, on the port's kernels: A1/A3/A4
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), their
masked schedule for the window, A5-A7 for the block mask and P1
(``csrc/paged_attention.cu``).

    python -m cubecl_tpu_torch.examples.attention      # on the card

The inputs are the JAX example's (numpy's RandomState(0), in its order);
``launch(device="cpu")`` runs the plain versions, as the CPU tests do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import (flash_attention, flash_attention_block_sparse,
                             flash_attention_local)
from ..ops.paged_attention import paged_attention

B, H, S, D = 1, 2, 512, 128
BLOCK = 128
HKV, PAGES, PAGE, CONTEXT = 2, 4, 128, 300


def inputs(device="cuda"):
    """q, k, v (B, H, S, D), the K and V pools (1, Hkv, pages, page, D),
    the block table, the lengths and the decode queries (B, H, D), f32 on
    ``device``, drawn as the JAX example draws them."""
    rng = np.random.RandomState(0)
    q = rng.randn(B, H, S, D).astype(np.float32) * 0.3
    k = rng.randn(B, H, S, D).astype(np.float32) * 0.3
    v = rng.randn(B, H, S, D).astype(np.float32)
    kp = rng.randn(HKV, PAGES, PAGE, D).astype(np.float32) * .3
    vp = rng.randn(HKV, PAGES, PAGE, D).astype(np.float32)
    table = np.tile(np.arange(PAGES, dtype=np.int32), (B, 1))
    lengths = np.full((B,), CONTEXT, np.int32)
    qd = rng.randn(B, H, D).astype(np.float32) * 0.3
    out = dict(q=q, k=k, v=v, k_pages=kp[None], v_pages=vp[None],
               table=table, lengths=lengths, q_decode=qd)
    return {n: torch.from_numpy(a).to(device) for n, a in out.items()}


def global_band_mask(n_tiles: int) -> np.ndarray:
    """The example's block mask: each q tile attends its own and the
    previous kv tile (a local band) and tile 0 (a global tile)."""
    bm = np.zeros((n_tiles, n_tiles), bool)
    for i in range(n_tiles):
        bm[i, max(0, i - 1):i + 1] = True
        bm[i, 0] = True
    return bm


def launch(device="cuda") -> dict:
    """The example's four calls; returns their results (f32 tensors)."""
    x = inputs(device)
    q, k, v = x["q"], x["k"], x["v"]

    # 1. dense causal flash: the training kernels (forward, dK/dV, dQ)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (flash_attention(*leaves, True, None, BLOCK, BLOCK) ** 2).sum().backward()
    dq, dk, dv = (t.grad for t in leaves)
    print(f"dense flash: loss grads ok, |dq|max={dq.abs().max().item():.3f}")

    # 2. sliding window (banded): the kernels walk the band's tiles only
    o_local = flash_attention_local(q, k, v, left=128, right=0,
                                    block_q=BLOCK, block_k=BLOCK)
    print(f"sliding-window(128): out[0,0,0,:2]="
          f"{o_local[0, 0, 0, :2].cpu().numpy()}")

    # 3. block-sparse: a local band and a global first tile; cost and
    # gradients scale with the mask's live tiles
    bm = global_band_mask(S // BLOCK)
    o_bsp = flash_attention_block_sparse(q, k, v, bm, True, None, BLOCK,
                                         BLOCK)
    qg = q.clone().requires_grad_()
    flash_attention_block_sparse(qg, k, v, bm, True, None, BLOCK,
                                 BLOCK).sum().backward()
    print(f"block-sparse (nnz={int(bm.sum())}/{bm.size} tiles): grad "
          f"|dq|max={qg.grad.abs().max().item():.3f}")

    # 4. paged-KV decode, the serving kernel: one query a sequence attends
    # scattered KV pages through a block table
    od = paged_attention(x["q_decode"], x["k_pages"], x["v_pages"],
                         x["table"], x["lengths"])
    print(f"paged decode (ctx={CONTEXT} over {PAGES} pages): "
          f"out[0,0,:2]={od[0, 0, :2].cpu().numpy()}")
    return dict(dq=dq, dk=dk, dv=dv, local=o_local, block_sparse=o_bsp,
                block_sparse_dq=qg.grad, paged=od)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("attention: needs a CUDA device")
    launch()


if __name__ == "__main__":
    main()
