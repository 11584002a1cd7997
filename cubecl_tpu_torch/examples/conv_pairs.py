"""Small-channel conv chains in the pair-packed layout: the twin of the JAX
package's ``examples/conv_pairs.py``, on C1 (``csrc/conv3x3.cu``).

A stack of C <= 64 convolutions packs once (``pack_pairs``), chains
``conv2d_pairs_packed`` and ReLU (elementwise ops work on the packed layout
unchanged) and unpacks once. On the H100 the packed layout is NHWC with 64
channels a pixel, so packing costs nothing beyond the channel padding; the
stack is held against ``torch.nn.functional.conv2d`` + ReLU within the JAX
example's 0.15 (bf16, three layers).

    python -m cubecl_tpu_torch.examples.conv_pairs         # on the card
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops.conv import conv2d_pairs_packed, pack_pairs, unpack_pairs

CPU_SHAPE = (4, 28, 28, 64)    # (N, H, W, C) of the JAX example off the TPU
CARD_SHAPE = (32, 56, 56, 64)  # and on a chip: ResNet-50's conv2_x
DEPTH = 3
TOL = 0.15                     # the JAX example's bound on max |err|


def inputs(N, H, W, C, depth=DEPTH, device="cuda"):
    """The JAX example's inputs: numpy's default_rng(0), x then each
    filter, standard normal x 0.1, in bf16, on ``device`` (the card unless
    the caller asks for the CPU)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, H, W, C)) * 0.1)
    ws = [torch.from_numpy(rng.standard_normal((3, 3, C, C)) * 0.1)
          for _ in range(depth)]
    return (x.to(device, torch.bfloat16),
            [w.to(device, torch.bfloat16) for w in ws])


def stack_packed(x, ws, H):
    """Pack once, chain packed convs + ReLU, unpack once."""
    N, _, W, C = x.shape
    xp = pack_pairs(x)
    for w in ws:
        xp = torch.relu(conv2d_pairs_packed(xp, w, H))
    return unpack_pairs(xp, H, W, C)


def stack_reference(x, ws):
    """The same stack on ``torch.nn.functional.conv2d`` (channels_last,
    each layer rounded to x's dtype) + ReLU."""
    y = x.permute(0, 3, 1, 2)
    for w in ws:
        y = torch.relu(TF.conv2d(y, w.permute(3, 2, 0, 1), padding=1))
    return y.permute(0, 2, 3, 1)


def check(got, x, ws) -> float:
    """max |got - reference| in f32."""
    ref = stack_reference(x, ws)
    return float((got.float() - ref.float()).abs().max())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("conv_pairs: needs a CUDA device")
    N, H, W, C = CARD_SHAPE
    x, ws = inputs(N, H, W, C)
    got = stack_packed(x, ws, H)
    err = check(got, x, ws)
    print(f"{DEPTH}-layer packed conv stack: max |err| vs F.conv2d = "
          f"{err:.4f} (bf16 envelope)")
    assert err < TOL, err


if __name__ == "__main__":
    main()
