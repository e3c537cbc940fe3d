"""Instruction counts of the built kernel library, from its SASS.

``cuobjdump -sass`` (CUDA toolkit) disassembles the library that
``ops/kernels.py`` built; this module splits the listing by kernel, finds
each kernel's draw loop (the backward branch whose body holds the stores)
and counts the loop's instructions by class, per Box-Muller pair: a draw
of a noise or sampler kernel stores 16 bytes per thread in each quarter of
its block, K = 16 / sizeof(out) values, so one 16-byte store stands for
K / 2 pairs. Static counts: what one pass of the loop issues, not a
profile.

Runs where ``cuobjdump`` is, beside ``nvcc`` on the machine with the card;
``parse`` and ``loop_counts`` are pure and run anywhere.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
from collections import Counter
from typing import Dict, List, Optional, Tuple

# opcode (the mnemonic before its first ".") -> class. The classes follow
# the H100's issue pipes: FP32 (128 lanes an SM), IMAD (the FMA-heavy
# half: 64), the integer ALU (64), conversions and MUFU (16), compares,
# selects and logic (ALU), memory, control.
CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FADD32I", "FMUL32I",
             "FFMA32I", "FSWZADD"),
    "imad": ("IMAD", "IMUL", "IMAD32I"),
    "int_alu": ("IADD3", "IADD", "IADD32I", "SHF", "LEA", "IABS", "IMNMX",
                "FLO", "POPC", "BREV", "BMSK", "SGXT"),
    "conv_mufu": ("I2F", "F2I", "F2F", "F2FP", "FRND", "MUFU", "I2FP",
                  "F2IP", "FCHK"),
    "select_logic": ("LOP3", "LOP", "LOP32I", "FSEL", "SEL", "ISETP",
                     "FSETP", "PLOP3", "PRMT", "P2R", "R2P", "VOTE"),
    "memory": ("LDG", "STG", "LDC", "LDS", "STS", "LD", "ST", "ULDC",
               "ATOM", "RED", "LDGSTS"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "CALL", "RET", "NOP", "BAR",
                "WARPSYNC", "BMOV", "JMP"),
}
_CLASS_OF = {op: c for c, ops in CLASSES.items() for op in ops}

_FUNC_RE = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN_RE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL_RE = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET_RE = re.compile(r"`\((\.L_x_\d+)\)")
_NOISE = {"0": "kF32", "1": "kFast", "2": "kLite", "3": "kBits"}


def class_of(opcode: str) -> str:
    return _CLASS_OF.get(opcode.split(".")[0], "other")


def short_name(demangled: str) -> str:
    """``void <unnamed>::noise_kernel<__nv_bfloat16, (<unnamed>::Noise)1>
    (...)`` -> ``noise_kernel<bf16,kFast>``; other names unchanged."""
    m = re.search(r"(\w+_kernel)<(.*)>\(", demangled)
    if not m:
        return demangled
    args = re.sub(r"\((?:[^()]|\([^()]*\))*Noise\)(\d)",
                  lambda a: _NOISE.get(a.group(1), a.group(1)), m.group(2))
    args = args.replace("__nv_bfloat16", "bf16").replace("float", "f32")
    return f"{m.group(1)}<{','.join(a.strip() for a in args.split(','))}>"


def parse(listing: str) -> Dict[str, List[Tuple[int, str, Optional[str]]]]:
    """Function name -> [(address, instruction text, label at it or None)]
    from a ``cuobjdump -sass`` listing."""
    funcs: Dict[str, list] = {}
    cur, label = None, None
    for line in listing.splitlines():
        m = _FUNC_RE.match(line)
        if m:
            cur, label = funcs.setdefault(m.group(1), []), None
            continue
        if cur is None:
            continue
        m = _LABEL_RE.match(line)
        if m:
            label = m.group(1)
            continue
        m = _INSN_RE.match(line)
        if m:
            cur.append((int(m.group(1), 16), m.group(2), label))
            label = None
    return funcs


def _opcode(text: str) -> str:
    toks = text.split()
    if toks and toks[0].startswith("@"):  # predicate guard
        toks = toks[1:]
    return toks[0] if toks else ""


def _branch_target(text: str, labels: Dict[str, int]) -> Optional[int]:
    """The address a BRA jumps to: ``BRA 0x930`` (cuobjdump) or
    ``BRA `(.L_x_1)`` (nvdisasm)."""
    m = _TARGET_RE.search(text)
    if m:
        return labels.get(m.group(1))
    m = re.search(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?(0x[0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


def loop_counts(insns: List[Tuple[int, str, Optional[str]]], k_vec: int
                ) -> Optional[Dict]:
    """Counts of the loop that holds the most 16-byte stores: per class and
    per opcode for one pass, the pass's pairs (stores x K / 2) and the
    counts per pair. None when no backward branch encloses a store."""
    labels = {lab: a for a, _, lab in insns if lab}
    best = None
    for addr, text, _ in insns:
        if _opcode(text).split(".")[0] != "BRA":
            continue
        target = _branch_target(text, labels)
        if target is None or target > addr:
            continue
        body = [t for a, t, _ in insns if target <= a <= addr]
        stores = sum(1 for t in body if _opcode(t).startswith("STG.E.128"))
        if stores and (best is None or stores > best[0]):
            best = (stores, body)
    if best is None:
        return None
    stores, body = best
    ops = Counter(_opcode(t) for t in body)
    classes = Counter()
    for op, n in ops.items():
        classes[class_of(op)] += n
    pairs = stores * k_vec // 2
    return {"instructions": len(body), "pairs": pairs,
            "per_pair": {c: classes[c] / pairs for c in sorted(classes)},
            "per_pair_total": len(body) / pairs,
            "opcodes": dict(ops.most_common())}


def vec_of(name: str) -> int:
    """Values per 16-byte store of a kernel by its ``short_name``: 8 where
    it writes bf16, else 4 (f32). The output type: noise_kernel<TOut, N>,
    sampler_kernel<TIn, TOut, N, kSoftplus>; bf16_stacked_kernel<TIn>
    writes bf16."""
    args = name[name.find("<") + 1:-1].split(",")
    t_out = ("bf16" if name.startswith("bf16_stacked_kernel") else args[1]
             if name.startswith("sampler_kernel") else args[0])
    return 8 if t_out == "bf16" else 4


def _tool(name: str) -> str:
    from multimodal_auv_torch.ops.kernels import nvcc

    path = os.path.join(os.path.dirname(nvcc()), name)
    return path if os.access(path, os.X_OK) else (shutil.which(name) or name)


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Mangled kernel name -> registers and spill bytes, from the
    ``-Xptxas -v`` lines of a build log."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$.]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def library_counts(lib_path, build_log: str = "") -> Dict[str, Dict]:
    """Per kernel of a built library (short name): its draw loop's counts
    (``loop_counts``), by ``cuobjdump -sass`` and ``cu++filt``, with its
    registers and spills from ``build_log`` where it has them."""
    listing = subprocess.run([_tool("cuobjdump"), "-sass", str(lib_path)],
                             capture_output=True, text=True, check=True,
                             timeout=120).stdout
    funcs = parse(listing)
    ptxas = ptxas_report(build_log)
    names = list(funcs)
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    if len(demangled) != len(names):
        raise RuntimeError(f"cu++filt gave {len(demangled)} names for "
                           f"{len(names)}")
    out = {}
    for mangled, dm in zip(names, demangled):
        name = short_name(dm)
        counts = loop_counts(funcs[mangled], vec_of(name))
        if counts is not None:
            counts.update(ptxas.get(mangled, {}))
            out[name] = counts
    return out
