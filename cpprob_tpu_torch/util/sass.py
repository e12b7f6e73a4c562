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
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
from pathlib import Path

from ..ops._build import NVCC_FLAGS, _nvcc

__all__ = ["compare", "parse_registers", "parse_sass"]

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_REGS = re.compile(r"Used (\d+) registers")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


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
