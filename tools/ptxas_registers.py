"""Registers and spills of every kernel in CUDA sources, as ptxas reports
them under the port's nvcc flags (midgpt_tpu_torch/kernels/build.py
`NVCC_FLAGS`, `ptxas_report`), one JSON line per kernel instantiation.

    python tools/ptxas_registers.py midgpt_tpu_torch/csrc/flash_attention.cu [OTHER.cu ...]

Each line: {"source", "kernel" (the mangled name), "C" and "causal" where
the name carries them (the flash templates' head dim and causal flag),
"registers", "spill_stores", "spill_loads"}. Comparing two versions of a
source (say, a commit's and its parent's) shows whether a change moved
any instantiation's registers. Needs nvcc (the CUDA machine); builds into
a temporary directory and loads nothing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from midgpt_tpu_torch.kernels.build import NVCC_FLAGS, _nvcc, ptxas_report  # noqa: E402


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for source in argv:
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(Path(tmp) / "lib.so"), source],
                                 capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"nvcc failed on {source}:\n{out.stdout}{out.stderr}")
        for row in ptxas_report(out.stdout + out.stderr):
            print(json.dumps({"source": source, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
