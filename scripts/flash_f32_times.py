"""Time the f32 flash bodies of one checkout on the card, so that a parent
and a change can be compared in one chip call.

For each case (the f32 shapes of ``chip_smoke.py``'s phases d, 6, zd1 and
ze1, and ze1's kv_len case at D 128 on the masked schedule): A1's forward with its lse, A3's dK/dV and A4's dQ with a cold L2
(``chip_smoke.cold_ms``), their shares of the bounds
(``chip_smoke.flash_bound``, 3xTF32), and SDPA's f32 forward and backward
(TF32 off, ``enable_gqa``; the backward's dq, dk and dv against A3 + A4)
with a cold L2 beside them. Then the d768 f32
llama's prefill at B 16 x S 384 and one training step at B 4 x S 384
(``chip_smoke.f32_prefill_ms`` and ``f32_step_ms``, phases 6 and g). DIR's
package is imported and only the flash files of its csrc are built; the
timing helpers are this checkout's.

    python3 scripts/flash_f32_times.py --tree build/parent
    python3 scripts/flash_f32_times.py             # this checkout

Unpack the parent with ``git archive`` into a gitignored directory and run
parent, change, change, parent in one call. Prints a line a case and, last,
one JSON object of every number with the card's name and power limit.
"""

import argparse
import glob
import json
import os
import subprocess
import sys

# (name, B, H, Hkv, S, D, causal, options of the masked schedule)
CASES = [("d768 train (phase d)", 2, 12, 4, 384, 64, True, {}),
         ("d768 prefill (phase 6)", 16, 12, 4, 384, 64, True, {}),
         ("gpt-j D128 (zd1, ze1 beside)", 8, 16, 16, 1024, 128, True, {}),
         ("gpt-j D128 kv_len 900 (ze1's, masked)", 8, 16, 16, 1024, 128,
          True, dict(kv_len=900)),
         ("gpt-j D256 (zd1, ze1)", 8, 16, 16, 1024, 256, True, {}),
         ("qwen3-next D256 (zd1, ze1)", 2, 16, 2, 4096, 256, True, {})]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".",
                    help="the checkout whose cubecl_tpu_torch is timed")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as TF

    if not torch.cuda.is_available():
        print("flash_f32_times: no CUDA device", file=sys.stderr)
        return 2
    from cubecl_tpu_torch.models import llama
    from cubecl_tpu_torch.ops import attention as fa
    from cubecl_tpu_torch.utils import native
    if not native.__file__.startswith(tree):
        raise SystemExit(f"imported {native.__file__}, not {tree}'s")
    sys.path.insert(0, here)  # this checkout's timing helpers
    import chip_smoke as cs

    csrc = native.CSRC_DIR
    native._sources = lambda: (
        [os.path.join(csrc, f) for f in ("flash_attention.cu",
                                         "flash_attention_bwd.cu")],
        sorted(glob.glob(os.path.join(csrc, "*.cuh"))))
    native._SIGNATURES = {k: v for k, v in native._SIGNATURES.items()
                          if k.startswith("cubecl_flash")}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    build = native.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": args.tree, "card": card, "build_s": build.seconds,
           "cases": {}}
    f32 = torch.float32
    for name, B, H, Hkv, S, D, causal, opts in CASES:
        q, do = (torch.randn(B, H, S, D, generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, generator=gen, device=dev)
                for _ in range(2))
        fwd_k, dkv_k, dq_k, _ = cs._a34_kernels(fa, q, k, v, do, causal,
                                                None, opts)
        fwd_k()
        fwd = cs.cold_ms(fwd_k)
        dkv = cs.cold_ms(dkv_k)
        dq = cs.cold_ms(dq_k)
        # the live (query, key) pairs of a row and head, and SDPA's mask
        kv_len = opts.get("kv_len", S)
        pairs = sum(min(i + 1, kv_len) for i in range(S))
        live = (torch.ones(S, S, dtype=torch.bool, device=dev).tril()
                & (torch.arange(S, device=dev) < kv_len)) if opts else None

        def sdpa(q_, k_, v_):
            return TF.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=live, is_causal=live is None,
                enable_gqa=True)

        lib_fwd = cs.cold_ms(lambda: sdpa(q, k, v))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o_s = sdpa(*leaves)
        lib_bwd = cs.cold_ms(lambda: torch.autograd.grad(
            o_s, leaves, do, retain_graph=True))
        b_fwd = cs.flash_bound(B, H, Hkv, S, S, D, f32, causal, pairs=pairs)
        b_dkv = cs.flash_bound(B, H, Hkv, S, S, D, f32, causal, 4,
                               4 * D * 2 * B * Hkv * S + 8 * B * H * S,
                               pairs)
        b_dq = cs.flash_bound(B, H, Hkv, S, S, D, f32, causal, 3,
                              4 * D * B * H * S + 8 * B * H * S, pairs)
        row = dict(fwd_ms=fwd, dkv_ms=dkv, dq_ms=dq, sdpa_fwd_ms=lib_fwd,
                   sdpa_bwd_ms=lib_bwd, fwd_bound_ms=b_fwd[0],
                   dkv_bound_ms=b_dkv[0], dq_bound_ms=b_dq[0],
                   bound_by=b_fwd[1])
        out["cases"][name] = row
        print(f"{name}: f32 B{B} H{H}/{Hkv} S{S} D{D}: A1 {fwd:.4f} ms "
              f"({100 * b_fwd[0] / fwd:.1f}% of {b_fwd[0]:.4f}), A3 dK/dV "
              f"{dkv:.4f} ms ({100 * b_dkv[0] / dkv:.1f}% of {b_dkv[0]:.4f}"
              f", {b_dkv[1]}), A4 dQ {dq:.4f} ms ({100 * b_dq[0] / dq:.1f}% "
              f"of {b_dq[0]:.4f}); A3 + A4 {dkv + dq:.4f} ms; SDPA forward "
              f"{lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms; cold L2 "
              f"[{card}]", flush=True)
        del q, k, v, do, fwd_k, dkv_k, dq_k, live, leaves, o_s
        torch.cuda.empty_cache()
    out["prefill_ms"] = cs.f32_prefill_ms(llama, dev)
    out["step_ms"] = cs.f32_step_ms(llama, dev)
    print(f"d768 f32 llama (8 layers): prefill B16 x S384 "
          f"{out['prefill_ms']:.3f} ms, train step B4 x S384 "
          f"{out['step_ms']:.3f} ms (medians of 5, host clock) [{card}]",
          flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
