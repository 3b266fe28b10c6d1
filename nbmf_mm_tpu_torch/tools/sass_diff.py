"""Compare, kernel by kernel, the SASS of the kernel library built from this
checkout with that of a library built from another copy of the sources (for
example the parent commit, unpacked with ``git archive``).

    python -m nbmf_mm_tpu_torch.tools.sass_diff --other <dir>/nbmf_mm_tpu_torch/ops/csrc \\
        [--match REGEX] [--ignore REGEX] [--other-library PATH]

Both are built with the flags of :mod:`~nbmf_mm_tpu_torch.ops._build`
(``--other-library`` takes the other copy's library as already built);
``cuobjdump -sass`` lists each kernel's code, and the anonymous-namespace
tags that nvcc derives from a source's path are taken out of the names and
the code before the comparison.  Prints one line per kernel that differs or
exists on one side only, then a summary; exits 1 if a kernel that matches
``--match`` and not ``--ignore`` (the kernels a change meant to replace or
add) differs or is missing on either side.  ``--diff N`` shows
where.  Needs the CUDA toolkit
(``nvcc``, ``cuobjdump``), not a card.
"""

from __future__ import annotations

import argparse
import difflib
import re
import shutil
import subprocess
import sys
from pathlib import Path

from ..ops import _build

# Lines of cuobjdump's output that belong to no kernel: the fatbin and cubin
# headers between one object's kernels and the next object's.
_HEADERS = ("...", "Fatbin", "code for", "=====", "arch =", "code version =", "host =",
            "compile_size =")
# nvcc's tag for an anonymous namespace: _GLOBAL__N__<hash>_<len>_<file>_<hash>
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_[0-9a-f]{8}")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(_build._nvcc()).with_name("cuobjdump"))


def parse_sass(text: str) -> dict:
    """{kernel name: code} from ``cuobjdump -sass`` output, anonymous tags
    removed from both and runs of blanks collapsed."""
    text = _ANON.sub(r"_GLOBAL__N__\1", text)
    out, name, body = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = "\n".join(body)
            name, body = m.group(1), []
        elif name and line.strip() and not line.lstrip().startswith(_HEADERS):
            body.append(" ".join(line.split()))  # cuobjdump pads to the file's widest line
    if name:
        out[name] = "\n".join(body)
    return out


def kernels_sass(library: Path) -> dict:
    """{kernel name: SASS} of a built library."""
    return parse_sass(subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True,
                                     text=True, check=True).stdout)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, type=Path,
                        help="the other copy's csrc directory")
    parser.add_argument("--match", default=".",
                        help="regex: kernels whose names match must be identical")
    parser.add_argument("--other-library", type=Path, default=None,
                        help="the other copy's built library, in place of building --other")
    parser.add_argument("--ignore", default=None,
                        help="regex: kernels whose names match are not selected")
    parser.add_argument("--diff", type=int, default=0, metavar="N",
                        help="print the first N lines of a unified diff of each selected "
                             "kernel that differs")
    args = parser.parse_args(argv)
    here = _build.load_library()._name
    other = args.other_library
    if other is None:
        other = _build.BUILD_DIR / "sass_diff_other.so"
        _build._compile(other, args.other.resolve())
    mine, theirs = kernels_sass(Path(here)), kernels_sass(other)
    pattern = re.compile(args.match)
    ignore = re.compile(args.ignore) if args.ignore else None
    same, bad = 0, 0
    for name in sorted(set(mine) | set(theirs)):
        selected = bool(pattern.search(name)) and not (ignore and ignore.search(name))
        if name in mine and name in theirs and mine[name] == theirs[name]:
            same += selected
            continue
        where = ("differs" if name in mine and name in theirs
                 else "only here" if name in mine else "only in --other")
        bad += selected
        print(f"{where}{' (selected)' if selected else ''}: {name}")
        if selected and args.diff and where == "differs":
            diff = difflib.unified_diff(theirs[name].splitlines(), mine[name].splitlines(),
                                        "--other", "here", lineterm="", n=0)
            for line in list(diff)[:args.diff]:
                print("    " + line)
    print(f"sass_diff: {same} selected kernels identical, {bad} selected differ or are missing; "
          f"{len(mine)} kernels here, {len(theirs)} in --other (--match {args.match!r}, "
          f"--ignore {args.ignore!r})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
