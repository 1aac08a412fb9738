#!/usr/bin/env python3
"""Count the SASS instructions in the loops of the port's kernels.

    python3 flatmatch_tpu_torch/tools/sass_loops.py [--root ROOT] [--body] \
        NAME [NAME ...]

Builds (or finds) the kernel library of ROOT, a checkout of this repository
(by default the one holding this script), disassembles it with
`cuobjdump -sass` and prints one JSON line for every kernel whose symbol
holds one of the NAMEs: its instruction count, and for each loop (a
branch back to an earlier address) the instructions from the branch's
target to the branch itself, by opcode (the mnemonic before its first
dot). With --body the loops' instructions are printed too. It needs the
CUDA toolkit (nvcc builds the library; cuobjdump lies beside it) and no
card.
"""
import collections
import json
import pathlib
import re
import subprocess
import sys

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def kernels(sass: str):
    """(symbol, [(address, opcode, text)]) of each function of the dump."""
    out, name, body = [], None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                out.append((name, body))
            name, body = m.group(1), []
            continue
        m = _INSN.search(line)
        if m and name:
            body.append((int(m.group(1), 16), m.group(3),
                         (m.group(2) or "") + m.group(3) + m.group(4)))
    if name:
        out.append((name, body))
    return out


def loops(body):
    """[(start, end)] addresses of each backward branch's loop."""
    found = []
    for addr, op, text in body:
        m = re.search(r"BRA\s+(?:`\()?(?:\S+\s+)?0x([0-9a-f]+)", text)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            found.append((int(m.group(1), 16), addr))
    return found


def main(argv):
    root = pathlib.Path(__file__).resolve().parents[2]
    show = False
    while argv and argv[0] in ("--root", "--body"):
        if argv[0] == "--root":
            root, argv = pathlib.Path(argv[1]).resolve(), argv[2:]
        else:
            show, argv = True, argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from flatmatch_tpu_torch.utils import cuda_build

    cuda_build.load_library()
    lib = cuda_build.build_info["path"]
    if not pathlib.Path(lib).resolve().is_relative_to(root):
        raise RuntimeError(f"built {lib}, not under {root}")
    tool = pathlib.Path(cuda_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    for sym, body in kernels(sass):
        if not any(n in sym for n in argv):
            continue
        rec = {"kernel": sym, "instructions": len(body), "loops": []}
        for start, end in loops(body):
            ins = [b for b in body if start <= b[0] <= end]
            rec["loops"].append(dict(
                start=hex(start), end=hex(end), instructions=len(ins),
                opcodes=dict(collections.Counter(
                    op.split(".")[0] for _, op, _ in ins).most_common())))
            if show:
                rec["loops"][-1]["body"] = [t for _, _, t in ins]
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
