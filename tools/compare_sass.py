#!/usr/bin/env python3
"""Compare the SASS of CUDA kernels between two checkouts of the repo.

    python3 tools/compare_sass.py OLD_TREE NEW_TREE SOURCE.cu [SOURCE.cu ...]

Compiles each named source of ``src/repro_torch/kernels/csrc`` in both
trees with the port's own nvcc flags and compares the instruction
streams that ``cuobjdump -sass`` prints (addresses and encodings
stripped).  Prints one line per source and exits 1 if any differ.
Needs the CUDA toolkit (nvcc and cuobjdump).
"""
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import _build  # noqa: E402

CSRC = Path("src/repro_torch/kernels/csrc")
INSTRUCTION = re.compile(r"^\s+/\*[0-9a-f]{4}\*/\s+(.*?)\s*;?\s*/\*")


def sass(nvcc: str, source: Path, cubin: Path) -> list:
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", "-o", str(cubin),
                    str(source)], check=True)
    dump = subprocess.run(
        [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
        check=True, capture_output=True, text=True).stdout
    return [m.group(1) for m in map(INSTRUCTION.match, dump.splitlines())
            if m]


def main(old: str, new: str, *sources: str) -> int:
    nvcc = _build.nvcc_path()
    same_all = True
    with tempfile.TemporaryDirectory() as tmp:
        for name in sources:
            a, b = (sass(nvcc, Path(tree) / CSRC / name,
                         Path(tmp) / f"{k}_{name}.cubin")
                    for k, tree in enumerate((old, new)))
            same = a == b
            same_all &= same
            print(f"{name}: {len(a)} / {len(b)} instructions, "
                  f"identical={same}", flush=True)
    print("SASS IDENTICAL" if same_all else "SASS DIFFERS")
    return 0 if same_all else 1


if __name__ == "__main__":
    if len(sys.argv) < 4:
        sys.exit(__doc__)
    sys.exit(main(*sys.argv[1:]))
