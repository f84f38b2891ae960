"""Read a built library's machine code with the CUDA toolkit's tools:
kernel names (cu++filt), SASS listings (cuobjdump), the instructions a
kernel's main loop issues, and the time the card needs just to issue a
count of instructions. chip_smoke.py's [build], [k1], [k3] and [k5]
and scripts/k1_designs.py and k5_designs.py use them; they need the
toolkit, not a card.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

# SMs of the H100 SXM, its boost clock, and the warp instructions an SM
# issues a clock (4 schedulers of one each): the issue bound's terms
SMS = 132
BOOST_HZ = 1.98e9
ISSUE_PER_CLOCK = 4


def _tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def demangle(names: list) -> list:
    """Kernel names demangled by the toolkit's cu++filt, or as they are."""
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             text=True, capture_output=True,
                             timeout=60).stdout
    except OSError:
        return names
    lines = out.splitlines()
    return lines if len(lines) == len(names) else names


def kernel_name(demangled: str) -> str:
    """A demangled kernel's name with its template arguments, without its
    return type, anonymous namespace or parameters; template arguments
    written as cu++filt writes them ((bool)1, (int)4) read true, 4."""
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "",
                  demangled)
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    name = name.replace("(bool)1", "true").replace("(bool)0", "false")
    return re.sub(r"\(int\)(-?\d+)", r"\1", name)


def ptxas_summary(log: str) -> list:
    """One line per kernel of an `nvcc -Xptxas -v` log: its name
    (demangled by the toolkit's cu++filt, without its parameters),
    registers and spill bytes."""
    kernels, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"entry function '(\S+)'", line):
            name = m.group(1)
            kernels[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            kernels[name]["spills"] = f"{m.group(1)} B spill stores, " \
                                      f"{m.group(2)} B spill loads"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            kernels[name]["registers"] = int(m.group(1))
    shown = demangle(list(kernels))
    return [f"{kernel_name(full)}: {k.get('registers')} registers, "
            f"{k.get('spills')}" for full, k in zip(shown, kernels.values())]


def sass(path) -> str:
    """`cuobjdump -sass` of a built library."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(path)],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr}")
    return out.stdout


def sass_loop(listing: str, function: str):
    """The longest loop in one function of a `cuobjdump -sass` listing:
    from a backward branch's target to the branch, NOPs left out.
    `function` is the name `kernel_name` gives the function's demangled
    name. Returns (instructions, instructions issued when no branch skips
    into an out-of-line call, the loop's listing): the second leaves out
    each block that a predicated forward branch jumps over and that holds
    a CALL, such as an IEEE division's slow path, which runs only when
    FCHK flags its operands. (None, None, '') when the function or a loop
    is not there."""
    funcs, name = {}, None
    for line in listing.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            name = m.group(1)
            funcs[name] = ([], {})
        elif name and (m := re.match(r"\s*(\.L_x_\d+):", line)):
            funcs[name][1][m.group(1)] = None     # address of the next one
        elif name and (m := re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                     line)):
            addr, text = int(m.group(1), 16), m.group(2).strip()
            funcs[name][0].append((addr, text))
            labels = funcs[name][1]
            for label, at in labels.items():
                if at is None:
                    labels[label] = addr

    def target(text, labels):
        if not re.search(r"\bBRA\b", text):
            return None
        m = re.search(r"`\((\.L_x_\d+)\)", text) or re.search(
            r"(0x[0-9a-f]+)\s*$", text)
        if not m:
            return None
        return labels.get(m.group(1)) if m.group(1).startswith(".") \
            else int(m.group(1), 16)

    names = list(funcs)
    for mangled, full in zip(names, demangle(names)):
        if kernel_name(full) != function:
            continue
        instrs, labels = funcs[mangled]
        body = []
        for addr, text in instrs:
            to = target(text, labels)
            if to is not None and to <= addr:
                loop = [(a, t) for a, t in instrs if to <= a <= addr
                        and not t.startswith("NOP")]
                body = max(body, loop, key=len)
        if not body:
            return None, None, ""
        skipped = set()
        for addr, text in body:
            to = target(text, labels)
            if text.startswith("@") and to is not None and to > addr:
                block = [a for a, t in body if addr < a < to]
                if any(re.search(r"\bCALL\b", t) for a, t in body
                       if a in block):
                    skipped.update(block)
        return len(body), len(body) - len(skipped), "\n".join(
            f"/*{a:04x}*/ {'(skipped) ' if a in skipped else ''}{t}"
            for a, t in body)
    return None, None, ""


def issue_ms(instructions: float) -> float:
    """Milliseconds the card's SMs take to issue `instructions` thread
    instructions, 32 to a warp instruction, at ISSUE_PER_CLOCK warp
    instructions a clock on each SM at the boost clock."""
    return instructions / 32 / (ISSUE_PER_CLOCK * SMS * BOOST_HZ) * 1e3


def k1_pixels_a_thread() -> int:
    """csrc/esim.cu's kPix."""
    from ._build import CSRC
    src = (CSRC / "esim.cu").read_text()
    return int(re.search(r"constexpr int kPix = (\d+);", src).group(1))


def k5_shapes() -> dict:
    """csrc/sim_interleave.cu's kept thread shapes: {spp: (pixels a
    thread, threads a block)}."""
    from ._build import CSRC
    src = (CSRC / "sim_interleave.cu").read_text()
    return {int(spp): (int(pix), int(threads)) for spp, pix, threads in
            re.findall(r"struct Shape<(\d+)> \{ static constexpr int "
                       r"kPix = (\d+), kThreads = (\d+); \}", src)}


def loop_report(listing: str, function: str, pixels: int, clips: int = 1):
    """Instructions a pixel-frame in the quad loop (4 frames of `pixels`
    pixels of `clips` clips a thread) of `function` in a `cuobjdump
    -sass` listing: (all of the loop's, those it issues when no division
    takes its slow path, the loop's listing), or (None, None, '') when
    the loop was not found."""
    count, issued, body = sass_loop(listing, function)
    if count is None:
        return None, None, ""
    per = 4 * pixels * clips
    return count / per, issued / per, body


def k1_issue_report(library: Path):
    """`loop_report` of K1's main-path instance (uint8, noise, vector
    loads) in the built library: (all, issued, kPix, the loop's listing),
    or (None, None, kPix, '') when the loop was not found."""
    pix = k1_pixels_a_thread()
    count, issued, listing = loop_report(
        sass(library), f"esim_kernel<true, true, true, {pix}>", pix)
    return count, issued, pix, listing


def k5_issue_report(library: Path) -> dict:
    """`loop_report` of K5's uint8 instance with vector loads, for each
    kept spp: {spp: (all, issued, kPix, the loop's listing)}."""
    listing = sass(library)
    report = {}
    for spp, (pix, _) in k5_shapes().items():
        count, issued, body = loop_report(
            listing, f"sim_interleave_kernel<{spp}, true, true>", pix, spp)
        report[spp] = (count, issued, pix, body)
    return report
