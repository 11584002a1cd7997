#!/usr/bin/env python3
"""The flash kernels' machine code in this checkout against another's, on a
host with the CUDA toolkit.

    python3 scripts/flash_sass_diff.py --parent DIR

Compiles ``cubecl_tpu_torch/csrc/flash_attention.cu`` and
``flash_attention_bwd.cu`` of this checkout and of DIR alone (``nvcc -c``
with the port's flags, each against its own ``csrc`` headers, all four at
once), reads each object's SASS (``cuobjdump -sass``) and compares the
instructions of every instance on the dense and the block-sparse schedules
(addresses and encodings dropped; functions keyed by the name after the
anonymous namespace), then prints the registers and spills that ptxas
reports for each instance on the masked schedule (the options), for
each instance only this checkout holds and for every D 256 instance (the
forward's and the backward's, dense and masked, bf16 and f32). Exits 1
where an instance of the parent differs or is missing, or where an
instance only this checkout holds or a D 256 instance spills or keeps a
stack frame; needs nvcc, not a card.
"""

import argparse
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("flash_attention.cu", "flash_attention_bwd.cu")


def key(name):
    """A kernel's mangled name without the anonymous namespace."""
    m = re.search(r"\d+(flash_\w+)", name)
    return m.group(1) if m else name


def compile_one(nvcc, flags, tree, src, out):
    csrc = os.path.join(tree, "cubecl_tpu_torch", "csrc")
    return subprocess.Popen(
        [nvcc, *flags, "-I", csrc, "-c", "-o", out, os.path.join(csrc, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def read(proc, obj, cuobjdump):
    """({kernel: 'N registers, spill line'}, {kernel: [instructions]})."""
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
                    help="a checkout whose flash kernels to compare with")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from cubecl_tpu_torch.utils import native

    nvcc = native.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    regs = {"parent": {}, "this": {}}
    funcs = {"parent": {}, "this": {}}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {(n, f): (compile_one(nvcc, native.NVCC_FLAGS, t, f,
                                      os.path.join(tmp, f"{n}_{f}.o")),
                          os.path.join(tmp, f"{n}_{f}.o"))
                 for n, t in (("parent", args.parent), ("this", ROOT))
                 for f in FILES}
        for (n, _), (proc, obj) in procs.items():
            r, fs = read(proc, obj, cuobjdump)
            regs[n].update(r)
            funcs[n].update(fs)
    pf, tf = funcs["parent"], funcs["this"]
    same = 0
    for n in sorted(pf):
        eq = pf[n] == tf.get(n)
        same += eq
        print(f"{'same' if eq else 'DIFFERENT'} SASS ({len(pf[n])} "
              f"instructions): {n}; parent {regs['parent'].get(n)}, this "
              f"{regs['this'].get(n)}")
    for n in sorted(tf):
        if "Masked" in n:
            print(f"this, masked: {n}: {regs['this'].get(n)}, "
                  f"{len(tf[n])} instructions")
    def spills(n):
        r = regs["this"].get(n) or ""
        return "0 bytes stack frame, 0 bytes spill stores" not in r

    for n in sorted(set(tf) - set(pf)):
        print(f"this only: {n}: {regs['this'].get(n)}, {len(tf[n])} "
              "instructions")
    new_spill = sum(spills(n) for n in set(tf) - set(pf))
    d256 = sorted(n for n in tf if "Li256E" in n)
    for n in d256:
        print(f"this, D 256: {n}: {regs['this'].get(n)}")
    d256_spill = sum(spills(n) for n in d256)
    print(f"the parent's flash instances: SASS identical in {same} of "
          f"{len(pf)}; {len(set(tf) - set(pf))} only in this checkout, "
          f"{new_spill} of them with a stack frame or spills; {len(d256)} "
          f"D 256 instances, {d256_spill} with a stack frame or spills")
    return 0 if pf and same == len(pf) and not new_spill and not d256_spill \
        else 1


if __name__ == "__main__":
    sys.exit(main())
