#!/usr/bin/env python3
"""The plain decode's machine code (P1's ``paged_decode_kernel``) in this
checkout against another's, on a host with the CUDA toolkit.

    python3 scripts/p1_sass_diff.py --parent DIR

Compiles ``cubecl_tpu_torch/csrc/paged_attention.cu`` of this checkout and
of DIR alone (``nvcc -c`` with the port's flags, each against its own
``csrc`` headers, both at once), reads each object's SASS (``cuobjdump
-sass``) and compares the instructions of every ``paged_decode_kernel``
instance (addresses and encodings dropped; functions keyed by the name
after the anonymous namespace, which names the file), and prints each P1
kernel's registers and spills from ptxas. Exits 1 where an instance's
SASS differs or is missing; needs nvcc, not a card.
"""

import argparse
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def key(name):
    """A kernel's mangled name without the anonymous namespace."""
    m = re.search(r"\d+(paged_\w+)", name)
    return m.group(1) if m else name


def compile_tree(nvcc, flags, tree, out):
    csrc = os.path.join(tree, "cubecl_tpu_torch", "csrc")
    return subprocess.Popen(
        [nvcc, *flags, "-I", csrc, "-c", "-o", out,
         os.path.join(csrc, "paged_attention.cu")],
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
                    help="a checkout whose P1 to compare with")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from cubecl_tpu_torch.utils import native

    nvcc = native.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        objs = {n: os.path.join(tmp, f"{n}.o") for n in ("parent", "this")}
        procs = {n: compile_tree(nvcc, native.NVCC_FLAGS, t, objs[n])
                 for n, t in (("parent", args.parent), ("this", ROOT))}
        (pr, pf), (tr, tf) = (read(procs[n], objs[n], cuobjdump)
                              for n in ("parent", "this"))
    plain = sorted(n for n in pf if n.startswith("paged_decode_kernel"))
    same = 0
    for n in plain:
        eq = pf[n] == tf.get(n)
        same += eq
        print(f"{'same' if eq else 'DIFFERENT'} SASS ({len(pf[n])} "
              f"instructions): {n}; parent {pr.get(n)}, this {tr.get(n)}")
    for n in sorted(tf):
        if n.startswith(("paged_window_kernel", "paged_ring_kernel")):
            print(f"this: {n}: {tr.get(n)}, {len(tf[n])} instructions")
    print(f"plain decode: SASS identical in {same} of {len(plain)} "
          f"instances")
    return 0 if plain and same == len(plain) else 1


if __name__ == "__main__":
    sys.exit(main())
