#!/usr/bin/env python3
"""The machine code of P1 and P3 in this checkout against another's, on a
host with the CUDA toolkit.

    python3 scripts/p1_sass_diff.py --parent DIR

Compiles ``cubecl_tpu_torch/csrc/paged_attention.cu`` (P1),
``paged_ragged.cu`` (P1 at the head dims without an instance of their own,
where the checkout has it) and ``paged_chunked.cu`` (P3) of this checkout
and of DIR alone (``nvcc -c`` with the port's flags, each against its own
``csrc`` headers, all at once), reads each object's SASS (``cuobjdump -sass``) and compares the
instructions of every kernel instance that DIR's object holds (addresses
and encodings dropped; functions keyed by the name after the anonymous
namespace, which names the file): P1's ``paged_decode_kernel``,
``paged_window_kernel`` and ``paged_ring_kernel``, P3's
``paged_chunked_kernel`` (f32) and ``paged_chunked_wgmma_kernel`` (bf16),
and each file's ``paged_combine_kernel``. Instances only this checkout
holds (new head dims, such as D 256's or D 32's and 80's, P1's
``paged_grouped_kernel`` past 8 query heads a kv head) are listed with
their registers and spills from ptxas, then counted by head dim (the
ragged instances by their width). Exits 1
where one of DIR's instances differs or is missing, or where an instance
only this checkout holds spills or keeps a stack frame; needs nvcc, not
a card.
"""

import argparse
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("paged_attention.cu", "paged_ragged.cu", "paged_chunked.cu")


def key(name):
    """A kernel's mangled name without the anonymous namespace."""
    m = re.search(r"\d+(paged_\w+)", name)
    return m.group(1) if m else name


def compile_tree(nvcc, flags, tree, source, out):
    csrc = os.path.join(tree, "cubecl_tpu_torch", "csrc")
    return subprocess.Popen(
        [nvcc, *flags, "-I", csrc, "-c", "-o", out,
         os.path.join(csrc, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def read(proc, obj, cuobjdump):
    """({kernel: 'N regs, spill line'}, {kernel: [instructions]})."""
    log = proc.communicate()[0]
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{log[-4000:]}")
    regs, fn, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = key(m.group(1))
        if "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = f"{m.group(1)} registers, {spill}"
            fn = None
    sass = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = key(m.group(1))
            funcs[cur] = []
        elif cur:
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            if ins:
                funcs[cur].append(ins)
    return regs, funcs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout whose P1 and P3 to compare with")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from cubecl_tpu_torch.utils import native

    nvcc = native.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    ok = True
    def has(tree, source):
        return os.path.exists(os.path.join(tree, "cubecl_tpu_torch", "csrc",
                                           source))

    with tempfile.TemporaryDirectory() as tmp:
        jobs = {(t, s): os.path.join(tmp, f"{t}-{s}.o")
                for t, tree in (("parent", args.parent), ("this", ROOT))
                for s in SOURCES if has(tree, s)}
        procs = {(t, s): compile_tree(nvcc, native.NVCC_FLAGS,
                                      args.parent if t == "parent" else ROOT,
                                      s, obj)
                 for (t, s), obj in jobs.items()}
        got = {j: read(procs[j], jobs[j], cuobjdump) for j in jobs}
    for source in SOURCES:
        if ("this", source) not in got:
            continue
        (pr, pf) = got.get(("parent", source), ({}, {}))
        (tr, tf) = got["this", source]
        kinds = {}
        for n in sorted(pf):
            eq = pf[n] == tf.get(n)
            ok &= eq
            kind = re.match(r"(paged_\w+?_kernel)", n).group(1)
            same, total = kinds.get(kind, (0, 0))
            kinds[kind] = (same + eq, total + 1)
            print(f"{source}: {'same' if eq else 'DIFFERENT'} SASS "
                  f"({len(pf[n])} instructions): {n}; parent {pr.get(n)}, "
                  f"this {tr.get(n)}")
        new = {}
        for n in sorted(set(tf) - set(pf)):
            clean = "0 bytes stack frame, 0 bytes spill stores" in (
                tr.get(n) or "")
            ok &= clean
            print(f"{source}: this only: {n}: {tr.get(n)}, {len(tf[n])} "
                  f"instructions{'' if clean else ' (SPILLS)'}")
            # the head dim: the template's last int argument (Li80E)
            d = int(re.findall(r"Li(\d+)E", n)[-1])
            count, spills = new.get(d, (0, 0))
            new[d] = (count + 1, spills + (not clean))
        if new:
            print(f"{source}: this only, by head dim: " + ", ".join(
                f"D {d}: {c} ({s} spilling)" for d, (c, s) in sorted(
                    new.items())))
        print(f"{source}: the parent's instances, SASS identical: " + ", ".join(
            f"{k} {s} of {t}" for k, (s, t) in sorted(kinds.items())))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
