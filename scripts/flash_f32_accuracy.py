"""How close the f32 flash bodies come to float64 on the card, beside what
a plain f32 computation of the same math gives.

For each case, A1's forward (o) and A3's dK/dV (dk, dv, on the kernel's
own o and lse) against the same math in float64, and a plain f32 backward
(the plain version's formula computed in f32: materialized probabilities,
cuBLAS products with TF32 off, the group summed after) against float64
too. Prints the least atol (at rtol 1e-4) each needs:

    python3 scripts/flash_f32_accuracy.py

Cases: Qwen3-Next's 16 query heads on 2 kv heads at S 4096 (32,768 rows
summed into each dK, dV element) at D 256, 128 and 64, then GPT-J's shape
at D 128 with q and k scaled by 1, 1.5, 2 and 3.
"""

import os
import subprocess
import sys

CASES = [  # (name, B, H, Hkv, S, D, qk scale)
    ("qwen3-next", 2, 16, 2, 4096, 256, 1.0),
    ("qwen3-next", 2, 16, 2, 4096, 128, 1.0),
    ("qwen3-next", 2, 16, 2, 4096, 64, 1.0),
    ("gpt-j", 2, 16, 16, 1024, 128, 1.0),
    ("gpt-j", 2, 16, 16, 1024, 128, 1.5),
    ("gpt-j", 2, 16, 16, 1024, 128, 2.0),
    ("gpt-j", 2, 16, 16, 1024, 128, 3.0)]
LOG2E = 1.4426950408889634


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_accuracy: no CUDA device", file=sys.stderr)
        return 2
    from cubecl_tpu_torch.ops import attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def need(got, ref):  # the least atol at rtol 1e-4
        return max(((got.double() - ref).abs() - 1e-4 * ref.abs())
                   .max().item(), 0.0)

    def backward(q, k, v, o, lse, do, dtype):
        """dk, dv and o's math at ``dtype``, head by head, the group
        summed after (the plain version's formula)."""
        B, H, S, D = q.shape
        rep = H // k.shape[1]
        c = D ** -0.5
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        dk = torch.zeros(k.shape, dtype=dtype, device=dev)
        dv = torch.zeros_like(dk)
        out = torch.zeros(q.shape, dtype=dtype, device=dev)
        di = (do.to(dtype) * o.to(dtype)).sum(-1)
        for h in range(H):
            qh, doh = q[:, h].to(dtype), do[:, h].to(dtype)
            kh, vh = k[:, h // rep].to(dtype), v[:, h // rep].to(dtype)
            s = qh @ kh.transpose(-1, -2) * (c * LOG2E)
            out[:, h] = torch.softmax(s.masked_fill(~mask, -torch.inf)
                                      / LOG2E, -1) @ vh
            p = torch.where(mask, torch.exp2(
                s - lse[:, h, :, None].to(dtype)), 0.0)
            ds = p * (doh @ vh.transpose(-1, -2) - di[:, h, :, None]) * c
            dv[:, h // rep] += p.transpose(-1, -2) @ doh
            dk[:, h // rep] += ds.transpose(-1, -2) @ qh
        return out, dk, dv

    for name, B, H, Hkv, S, D, scale in CASES:
        q = torch.randn(B, H, S, D, generator=gen, device=dev) * scale
        k = torch.randn(B, Hkv, S, D, generator=gen, device=dev) * scale
        v = torch.randn(B, Hkv, S, D, generator=gen, device=dev)
        do = torch.randn(B, H, S, D, generator=gen, device=dev)
        o, lse = fa._flash_forward(q, k, v, True, None, True)
        di = (do * o).sum(-1)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, True)
        o64, dk64, dv64 = backward(q, k, v, o, lse, do, torch.float64)
        _, dk32, dv32 = backward(q, k, v, o, lse, do, torch.float32)
        print(f"{name} f32 B{B} H{H}/{Hkv} S{S} D{D} causal, q and k x"
              f"{scale}: atol needed at rtol 1e-4 against float64: kernel "
              f"o {need(o, o64):.3e}, dk {need(dk, dk64):.3e}, dv "
              f"{need(dv, dv64):.3e}; plain f32 dk {need(dk32, dk64):.3e}, "
              f"dv {need(dv32, dv64):.3e} [{card}]", flush=True)
        del q, k, v, do, o, lse, di, dk, dv, o64, dk64, dv64, dk32, dv32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
