"""How many clocks a ``wgmma`` instruction takes on the card, by shape
(m64n32k16 to m64n256k16) and operand layout (A K-major at aligned and
row-shifted starts; B N-major in the 64- or 128-byte swizzle, or
K-major), one warpgroup alone and two together: the measured probe behind
the choice of ``csrc/upconv_co32.cuh``'s form (one instruction a shift
over its parities' weight panels rather than one m64n32k16 a product).

    python -m text_to_image_tpu_torch.tools.wgmma_probe

Builds ``tools/wgmma_probe.cu`` (it includes the kernels' headers) with
nvcc into ``build/wgmma_probe/``, runs it, prints one line a
configuration and writes them with the card's name and power limit to
``chiprun_out/wgmma_probe.txt``.  Needs one NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys

from text_to_image_tpu_torch.ops.kernels import _build

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    out_dir = _build.BUILD_DIR.parent / "wgmma_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = out_dir / "wgmma_probe"
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(_build.CSRC), "-o",
                    str(exe), os.path.join(HERE, "wgmma_probe.cu")],
                   check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=300, check=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    text = f"{card}\n{run.stdout}"
    print(text, end="")
    report = os.path.join(os.getcwd(), "chiprun_out")
    os.makedirs(report, exist_ok=True)
    with open(os.path.join(report, "wgmma_probe.txt"), "w") as f:
        f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
