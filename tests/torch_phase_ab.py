"""Run one kernel phase of `chip_smoke.py` for several checkouts on one
card, in turns, each in a process of its own that builds its checkout's
kernels under that checkout's `build/`: the way two versions of a kernel
are compared within one call (a second call may land on another card).

    python tests/torch_phase_ab.py ssd_bwd_kernel_phase build/parent . . \\
        build/parent

prints the card's name and power limit, then for each run its checkout
and the phase's lines (as `chip_smoke.py` logs them). The phase is any
function of `chip_smoke.py` that takes the dtypes, f32 and bf16. Needs a
CUDA device; exits with the first failing run's code.
"""
import subprocess
import sys

RUN = """
import importlib.util, sys, torch
sys.path.insert(0, "src")
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels.build import library
library()
getattr(cs, sys.argv[1])((torch.float32, torch.bfloat16))
"""


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    phase, roots = argv[0], argv[1:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for i, root in enumerate(roots):
        print(f"== run {i + 1}: {root}", flush=True)
        r = subprocess.run([sys.executable, "-c", RUN, phase], cwd=root)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
