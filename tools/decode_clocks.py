#!/usr/bin/env python3
"""Where a step of ``sgs_decode``'s wide route spends its cycles, on the card.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 tools/decode_clocks.py

Copies ``src/repro_torch/kernels/csrc/sgs_decode.cu`` to
``build/decode_clocks/`` with ``clock64()`` reads added around the
sections of ``sgs_decode_wide_kernel`` (staging, the rank sort, and per
step: argmax and fetch, window search, placement, release), builds it
there and decodes, on the "wide" route, 8 rows of ``wide_instance`` at J
1194 and 1792 (M 2, T 256), 256 rows of ``grouped_instance`` at J 224, and
J 1792 twice more: with no edges and zero durations (a step's floor), and
with no edges and caps of 1e6 (one round of the search a step). Prints,
for the first row of each decode, the cycles of staging and of the sort,
the mean cycles a step of each section and the search rounds. A clock
read adds a few cycles to each section, and a section's loads may be paid
in the next section that uses them. Each decode is checked against the
plain version. The instrumented copy is found by text markers in the
source; the script fails if one is missing.
"""
from __future__ import annotations

import ctypes
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]

ACC = ("acc[0] += q1 - q0; acc[1] += q2 - q1; acc[2] += q3 - q2; "
       "acc[3] += q4 - q3;\n")
# (marker, text, insert after the marker)
PROBES = [
    ("namespace {\n", "__device__ unsigned long long g_clocks[16];\n", True),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  const int NW = (J + 31) >> 5;     // words of slots (<= 64)\n",
     "  long long P0 = clock64();\n"
     "  unsigned long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n", True),
    ("  if (!live) return;    // no block barrier below\n",
     "  long long P1 = clock64();\n", True),
    ("ce[m] = m < M ? caps_eps[m] : 0.0f;\n\n",
     "  long long P2 = clock64();\n", True),
    ("    __syncwarp();            // every lane's writes of the last step\n",
     "    long long q0 = clock64();\n", False),
    ("    // 3-4. the earliest t >= t0 = max(ready, 0) whose window [t, t + d)\n"
     "    //      lies in the grid and holds no overloaded bin, as on the fast",
     "    long long q1 = clock64();\n", False),
    ("    // 5. the placement, or the fallback\n"
     "    const bool any_ok = first != INT_MAX;\n"
     "    const int tstar = any_ok ? first : max(ready, T - d);\n"
     "    const int fin_j", "    long long q2 = clock64();\n", False),
    ("    // release the successors and push this finish into their ready "
     "bins:\n    // lane l releases", "    long long q3 = clock64();\n",
     False),
    ("  }\n  __syncwarp();\n\n  // --- write the row out",
     "    long long q4 = clock64();\n    " + ACC, False),
    ("      for (int k = t0 >> 5; k < K; k += kScanWords) {\n",
     "        ++acc[5];\n", True),
    ("  __syncwarp();\n\n  // --- write the row out, coalesced "
     "----------------------------------------\n",
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    g_clocks[0] = P1 - P0;\n    g_clocks[1] = P2 - P1;\n"
     "    for (int i = 0; i < 6; ++i) g_clocks[2 + i] = acc[i];\n"
     "    g_clocks[8] = clock64() - P0;\n  }\n", True),
]
READ = ('\nextern "C" int sgs_decode_clocks(unsigned long long* out) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, g_clocks, '
        'sizeof(g_clocks));\n}\n')
SECTIONS = ("argmax and fetch", "window search", "placement", "release")


def instrumented_source() -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc/sgs_decode.cu").read_text()
    for marker, text, after in PROBES:
        if src.count(marker) != 1:
            raise SystemExit(f"decode_clocks: marker not found once in "
                             f"sgs_decode.cu: {marker[:60]!r}")
        src = src.replace(marker, marker + text if after else text + marker)
    return src + READ


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from _decode_cases import grouped_instance, wide_instance
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import sgs_decode as kernel

    if not torch.cuda.is_available():
        print("decode_clocks: needs a CUDA card", file=sys.stderr)
        return 2
    out = ROOT / "build" / "decode_clocks"
    (out / "csrc").mkdir(parents=True, exist_ok=True)
    (out / "csrc" / "sgs_decode.cu").write_text(instrumented_source())
    _build.CSRC = out / "csrc"
    _build.use_build_dir(out / "lib")
    lib = kernel._library()
    lib.sgs_decode_clocks.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(chip_smoke.gpu_line())

    def clocks(name, arrays, T):
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = kernel.sgs_decode(*args, T=T, route="wide")
        chip_smoke.same_outputs(got, ops.sgs_decode(*args, T=T,
                                                    use_kernel=False))
        buf = (ctypes.c_ulonglong * 16)()
        if lib.sgs_decode_clocks(buf) != 0:
            raise SystemExit("decode_clocks: reading the clocks failed")
        J = arrays[0].shape[1]
        steps = ", ".join(f"{s} {buf[2 + i] / J:.1f}"
                          for i, s in enumerate(SECTIONS))
        print(f"{name}: staging {buf[0]} cycles, rank sort and row state "
              f"{buf[1]}; a step: {steps} cycles; {buf[7]} search rounds "
              f"in {J} steps; {buf[8]} cycles in all", flush=True)

    M, T = 2, 256
    rng = np.random.default_rng(5)
    for J in (1194, 1792):
        clocks(f"J {J}, 8 rows", wide_instance(rng, 1, 8, J, M, T), T)
    clocks("J 224, 256 rows (the shared shape's inputs)",
           grouped_instance(rng, 1, 256, 224, M, T)[1], T)
    J = 1792
    flat = wide_instance(rng, 1, 8, J, M, T)
    flat[0][:] = 0
    flat[4][:] = False
    clocks("J 1792, no edges, zero durations", flat, T)
    roomy = wide_instance(rng, 1, 8, J, M, T)
    roomy[4][:] = False
    roomy[5][:] = 1e6
    clocks("J 1792, no edges, caps 1e6", roomy, T)
    return 0


if __name__ == "__main__":
    if os.environ.get("DECODE_CLOCKS_SOURCE_ONLY"):
        instrumented_source()
        raise SystemExit(0)
    raise SystemExit(main())
