#!/usr/bin/env python3
"""Speculative decoding's rejection gaps against the verify step's logit
difference, at other seeds than ``chip_smoke.py``'s, on one CUDA card.

    python3 scripts/spec_gaps.py [--seeds 1,2]

For the llama at each width of ``chip_smoke.py`` phases zb2, zc2 and zd2
(Phi-3-mini's 32 layers, Mistral-Large-2's 8 of 88, GPT-J-6B's 28; bf16,
the kernels on) and each seed (the weights' and the prompt's): generate's
greedy stream written out (``chip_smoke.greedy_ref``), the verify step's
logits against the decode steps' after the same gamma + 1 tokens (max abs
difference, the phases' ``d_verify``), then ``speculative_generate`` with a
self-draft checked by ``chip_smoke.speculative_checked`` at twice that
difference, the tolerance ``serve_at_widths`` gives it. Prints the card
(``nvidia-smi``), a line a (width, seed) and one JSON line; exits 1 if a
rejection's gap or a token reached the tolerance; needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="1,2")
    seeds = [int(s) for s in ap.parse_args().seeds.split(",")]
    if not torch.cuda.is_available():
        print("spec_gaps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cubecl_tpu_torch.models import llama
    from cubecl_tpu_torch.ops import attention as fa
    from cubecl_tpu_torch.ops import paged_attention as pa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    failures = []
    cs.fail = lambda msg: (failures.append(msg), print(
        f"spec_gaps: FAILED: {msg}", file=sys.stderr, flush=True))
    torch.backends.cuda.matmul.allow_tf32 = False
    widths = [("Phi-3-mini", cs.PHI3, cs.PHI3_SERVE, None),
              ("Mistral-Large-2", cs.MISTRAL_LARGE_2, cs.ZC_SERVE,
               cs.ZC_LAYERS),
              ("GPT-J-6B", cs.GPTJ_6B, cs.ZD_SERVE, None)]
    rows = gaps(cs, llama, pa, fa, torch.device("cuda"), card, widths, seeds,
                failures)
    print(json.dumps({"card": card, "rows": rows}))
    return 1 if failures else 0


def gaps(cs, llama, pa, fa, dev, card, widths, seeds, failures):
    """One row a (width, seed): see the module's docstring. ``widths``:
    (name, the model's widths, the phase's sizes, layers or None);
    ``failures``: the list ``cs.fail`` appends to."""
    rows = []
    for name, w, t, layers in widths:
        cfg = llama.LlamaConfig(**dict(w, n_layers=layers or w["n_layers"]),
                                seq=t["S"], dtype="bfloat16",
                                use_framework_kernels=False)
        B, S, steps, g = t["B"], t["S"], t["steps"], t["gamma"]
        for seed in seeds:
            model = llama.init_params(cfg, seed=seed, device=dev)
            prompt = torch.from_numpy(np.random.default_rng(seed).integers(
                0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
            want, want_logits = cs.greedy_ref(llama, model, prompt, steps,
                                              t["pages"], t["page"])
            c = llama.init_kv_cache(cfg, B, t["pages"], t["page"], dev)
            _, c = llama.prefill(model, c, prompt)
            lg, c = llama.decode_chunk(model, c, want[:, :g + 1])
            d_verify = (lg.float() - want_logits[:, 1:g + 2]).abs().max(
            ).item()
            del c, lg
            n0 = len(failures)
            what = f"{name} seed {seed} speculative self-draft"
            _, acc, _, rounds, st = cs.speculative_checked(
                llama, pa, fa, model, model, prompt, steps, g, t["pages"],
                t["page"], want, want_logits, 2 * d_verify, True, what)
            row = dict(width=name, layers=cfg.n_layers, seed=seed,
                       d_verify=d_verify, tolerance=2 * d_verify,
                       rejections=st["rejections"],
                       max_rejection_gap=st["max_rejection_gap"],
                       prefix_min=st["prefix_min"], acceptance=acc,
                       rounds=rounds, ok=len(failures) == n0)
            rows.append(row)
            print(f"{what}: {cfg.n_layers} layers, B {B} x {steps} tokens, "
                  f"gamma {g}: verify-vs-decode logit difference "
                  f"{d_verify:.4f}, tolerance {2 * d_verify:.4f}; "
                  f"{st['rejections']} rejections in {rounds} rounds, "
                  f"largest gap {st['max_rejection_gap']:.4f}; tokens "
                  f"equal greedy up to the first near "
                  f"tie (prefix {st['prefix_min']}..{steps}) [{card}]",
                  flush=True)
            del model, want, want_logits
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
