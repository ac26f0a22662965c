"""Copies of a kernel source with one part changed, built side by side.

What the measurement tools (``leg_ablation``, ``fused_ab``) share: the text
edits that make a copy, one nvcc process per copy for sm_90a (all started
at once, each into a library of its own), the compiler's report of each
kernel, and the order in which copies are timed in turns.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

from ..ops import _build


def edited(text: str, edits) -> str:
    """``text`` with each ``(old, new)`` of ``edits`` replaced; raises if an
    ``old`` is not in it (the source moved on and the edit is stale)."""
    for old, new in edits:
        if old not in text:
            raise ValueError(f"edit text not in the source: {old!r}")
        text = text.replace(old, new)
    return text


def build(sources: dict, workdir: Path) -> dict:
    """Build every ``{name: (source text, include directory)}`` into a
    shared library in ``workdir``, all at once. Returns ``{name: (library
    path, compiler output)}``; raises if one fails."""
    procs = {}
    for k, (name, (text, include)) in enumerate(sources.items()):
        cu, so = workdir / f"variant{k}.cu", workdir / f"variant{k}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I",
             str(include), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = (str(so), log)
    return libs


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel of the compiler's output: its name, then its
    registers and shared memory, then its spills."""
    rows, cur = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            cur = found.group(1)
        elif cur and ("registers" in line or "spill" in line):
            rows.append(f"{cur}: {line.split('ptxas info    :')[-1].strip()}")
    return rows


def in_turns(names) -> list:
    """Each name twice, forward then backward, so that a drift of the
    card's clock during the run falls on every name alike."""
    names = list(names)
    return names + names[::-1]
