"""Compare the machine code (SASS) of two versions of the kernel sources.

    python -m cpprob_tpu_torch.util.sass OLD_CSRC NEW_CSRC NAME [NAME ...]

Each ``NAME.cu`` of the two ``csrc`` directories is compiled into a cubin
with the flags of ``ops/_build.py`` (``nvcc`` and ``cuobjdump`` from the
CUDA toolkit), and its SASS (``cuobjdump -sass``) and ptxas register lines
are compared function by function (a kernel in an anonymous namespace
carries a hash of its file's path in its mangled name; the names are read
without it).  Prints one JSON line per source: for
each function its registers and instruction count in each version and
whether the instructions are the same, so a change to a source that should
leave its kernels' code alone shows that it did.

:func:`kernel_report` reads one kernel of a library the port has built
(``ops/_build.py``): its registers and spills from the build's ptxas lines
and its opcodes from ``cuobjdump -sass`` of the library.
:func:`cubin_report` reads the kernels of any cubin (a Triton kernel's,
say) the same way, and :func:`parse_loops` the instructions of each loop.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import tempfile
from pathlib import Path

from ..ops._build import NVCC_FLAGS, _nvcc

__all__ = ["compare", "cubin_report", "kernel_report", "parse_loop_opcodes", "parse_loops",
           "parse_registers", "parse_sass", "parse_spills", "parse_stack"]

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_REGS = re.compile(r"Used (\d+) registers")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_STACK = re.compile(r"(\d+) bytes stack frame")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/")
_BRA = re.compile(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b)")


def _name(mangled: str) -> str:
    """A mangled name without the path hash of its anonymous namespace."""
    return _ANON.sub("_GLOBAL__N__", mangled)


def parse_sass(text: str) -> dict:
    """Function name -> its instructions (text, no addresses or encodings)
    from ``cuobjdump -sass`` output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(_name(m.group(1)), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append(" ".join(m.group(1).split()))
    return out


def parse_loop_opcodes(text: str) -> dict:
    """Function name -> ``(instruction count, {opcode: count})`` of each
    loop (a backward branch to a label or an address, counted from its
    target to the branch; opcodes counted as :func:`kernel_report` counts
    a function's), from ``cuobjdump -sass`` output, largest first."""
    out, cur = {}, None
    labels, addrs, branches, insns = {}, {}, [], []

    def close():
        if cur is not None:
            found = []
            for i, lab, addr in branches:
                j = labels.get(lab) if lab else addrs.get(addr)
                if j is not None and j <= i:
                    found.append((i - j + 1, _opcodes(insns[j:i + 1])[0]))
            out[cur] = sorted(found, key=lambda f: f[0], reverse=True)

    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            close()
            cur, labels, addrs, branches, insns = _name(m.group(1)), {}, {}, [], []
            continue
        m = _LABEL.match(line)
        if m:
            labels[m.group(1)] = len(insns)
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            a = _ADDR.search(line)
            if a:
                addrs[int(a.group(1), 16)] = len(insns)
            b = _BRA.search(m.group(1))
            if b:
                branches.append((len(insns), b.group(1),
                                 int(b.group(2), 16) if b.group(2) else None))
            insns.append(" ".join(m.group(1).split()))
    close()
    return out


def parse_loops(text: str) -> dict:
    """Function name -> the instruction count of each loop, largest first
    (:func:`parse_loop_opcodes` without the opcodes)."""
    return {f: [c for c, _ in loops] for f, loops in parse_loop_opcodes(text).items()}


def _opcodes(insns) -> tuple:
    ops, full = collections.Counter(), collections.Counter()
    for i in insns:
        words = i.split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            ops[words[0].split(".")[0]] += 1
            full[words[0]] += 1
    return dict(ops), dict(full)


def _dump(binary: Path, out: Path | None) -> str:
    """``cuobjdump -sass`` of ``binary`` (also written to ``out``)."""
    text = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass", str(binary)],
                          capture_output=True, text=True, check=True).stdout
    if out is not None:
        out.write_text(text)
    return text


def cubin_report(cubin: Path, kernel: str = "", out: Path | None = None) -> dict:
    """The kernels of ``cubin`` whose names contain ``kernel``: for each,
    its instruction count, the count of each opcode (as
    :func:`kernel_report`), local-memory accesses (``LDL``/``STL``) and the
    instruction count of its loops (:func:`parse_loops`).  ``out``: a file
    for the whole SASS."""
    text = _dump(cubin, out)
    loops = parse_loops(text)
    found = {}
    for f, insns in parse_sass(text).items():
        if kernel in f:
            ops, full = _opcodes(insns)
            found[f] = {"instructions": len(insns), "opcodes": ops, "full": full,
                        "ldl_stl": ops.get("LDL", 0) + ops.get("STL", 0),
                        "loops": loops.get(f, [])}
    return found


def parse_registers(log: str) -> dict:
    """Function name -> registers, from ``ptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = _name(m.group(1))
            continue
        m = _REGS.search(line)
        if m and cur is not None:
            out[cur] = int(m.group(1))
            cur = None
    return out


def parse_spills(log: str) -> dict:
    """Function name -> (spill store bytes, spill load bytes), from ``ptxas
    -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _PROPS.search(line)
        if m:
            cur = _name(m.group(1))
            continue
        m = _SPILL.search(line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), int(m.group(2)))
            cur = None
    return out


def parse_stack(log: str) -> dict:
    """Function name -> bytes of its stack frame (local memory it keeps
    besides spills: arrays indexed at run time, say), from ``ptxas -v``
    output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _PROPS.search(line)
        if m:
            cur = _name(m.group(1))
            continue
        m = _STACK.search(line)
        if m and cur is not None:
            out[cur] = int(m.group(1))
            cur = None
    return out


def kernel_report(lib: str, kernel: str, out: Path | None = None) -> dict:
    """The kernels of the built library ``lib`` (``ops/_build.py``, built
    by this process: a ``csrc`` name or a generated library's
    "<name>-<hash>") whose mangled names contain ``kernel``: for each, its
    registers, spill bytes, stack frame bytes, the count of each opcode in its SASS (the
    mnemonic before the first dot, predicates dropped), of each opcode
    with its modifiers (``full``, e.g. ``HMMA.1688.F32.TF32``), the
    instruction count of each loop (``loops``, :func:`parse_loops`) and the
    count of each opcode in each loop (``loop_opcodes``, in that order;
    :func:`parse_loop_opcodes`).
    ``out``: a file for the library's whole SASS."""
    from ..ops import _build

    text = _dump(_build.library_path(lib), out)
    log = _build.BUILD_LOGS.get(lib, "")
    regs, spills, stack = parse_registers(log), parse_spills(log), parse_stack(log)
    loops = parse_loop_opcodes(text)
    found = {}
    for f, insns in parse_sass(text).items():
        if kernel not in f:
            continue
        ops, full = _opcodes(insns)
        found[f] = {"registers": regs.get(f), "spills": spills.get(f),
                    "stack": stack.get(f), "instructions": len(insns), "opcodes": ops,
                    "full": full, "loops": [c for c, _ in loops.get(f, [])],
                    "loop_opcodes": [o for _, o in loops.get(f, [])]}
    return found


def _build(csrc: Path, name: str, cubin: Path):
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([_nvcc(), *flags, "-cubin", "-o", str(cubin),
                           str(csrc / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{proc.stderr}")
    dump = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True)
    return parse_sass(dump.stdout), parse_registers(proc.stdout + proc.stderr)


def compare(old: Path, new: Path, name: str) -> dict:
    """The functions of ``name.cu`` in the two source directories, side by
    side (old, new)."""
    with tempfile.TemporaryDirectory() as tmp:
        a, ra = _build(old, name, Path(tmp) / "old.cubin")
        b, rb = _build(new, name, Path(tmp) / "new.cubin")
    funcs = {}
    for f in sorted(set(a) | set(b)):
        funcs[f] = {"registers": [ra.get(f), rb.get(f)],
                    "instructions": [len(a.get(f, [])), len(b.get(f, []))],
                    "same": a.get(f) == b.get(f)}
    return {"source": f"{name}.cu", "same": all(v["same"] for v in funcs.values()),
            "functions": funcs}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("names", nargs="+")
    args = ap.parse_args(argv)
    for name in args.names:
        print(json.dumps(compare(args.old, args.new, name)))


if __name__ == "__main__":
    main()
