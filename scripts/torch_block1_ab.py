"""Times of the port's block-1 kernels at one DeLoRes-S training view, for
one checkout or as an A/B of two on one GPU, in turns (A, B, B, A), each run
in a process of its own:

    python scripts/torch_block1_ab.py <tree>
    python scripts/torch_block1_ab.py <tree A> <tree B>

Each run builds that tree's kernels into its own .torch_build/ and times
them with this checkout's ``chip_smoke.block1_times`` ([256, 1, 64, 96]
bf16: kernel, plain version and cuDNN composition as CUDA graph replays;
the backward passes' launches apart by torch.profiler; not the batch
statistics, which an older tree cannot capture in a graph), so that an
older tree is timed the same way. It prints the run's own lines and then one
line ``<label> <tree> AB {kernel: ms}``.
"""
import os
import subprocess
import sys

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")

CODE = """
import importlib.util, json, subprocess, sys, torch
sys.path.insert(0, ROOT)
spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from audiossl_tpu_torch import kernels
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.load("block1")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
out = cs.block1_times(torch.device("cuda"), card, stats=False)
print("AB", json.dumps({k: {"ms": v["ms"], **{n: ms for n, ms in v.get("launch_ms", {}).items()}} for k, v in out.items()}))
"""


def main() -> None:
    trees = sys.argv[1:3]
    order = [("A", trees[0])] if len(trees) == 1 else [("A", trees[0]), ("B", trees[1]), ("B", trees[1]), ("A", trees[0])]
    for label, root in order:
        code = CODE.replace("ROOT", repr(os.path.abspath(root))).replace("SMOKE", repr(SMOKE))
        r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
        lines = r.stdout.splitlines()
        for line in lines:
            if not line.startswith("AB "):
                print(f"  {label}: {line}")
        ab = [line for line in lines if line.startswith("AB ")]
        print(label, root, ab[-1] if ab else r.stderr[-3000:], flush=True)


if __name__ == "__main__":
    main()
