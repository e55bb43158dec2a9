"""A/B of the port's MAST-B attention kernels between two checkouts on one
GPU, in turns (A, B, B, A), each in a process of its own:

    python scripts/torch_attention_ab.py <tree A> <tree B>

Each run calls that tree's ``chip_smoke.attention_times`` (the three kernels
at every MAST-B shape, CUDA graph replays, summed over one SS-MAST step) and
prints one line ``<label> AB {kernel: ms a step}``. Each tree builds its own
kernels into its own .torch_build/.
"""
import json
import subprocess
import sys

CODE = """
import json, sys, torch
sys.path.insert(0, ROOT)
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
out = cs.attention_times(torch.device("cuda"), "card")
print("AB", json.dumps({k: v["ms"] for k, v in out.items()}))
"""


def main() -> None:
    a, b = sys.argv[1:3]
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        r = subprocess.run([sys.executable, "-c", CODE.replace("ROOT", repr(root))], cwd=root, capture_output=True, text=True)
        lines = [line for line in r.stdout.splitlines() if line.startswith("AB ")]
        print(label, root, lines[-1] if lines else r.stderr[-3000:], flush=True)


if __name__ == "__main__":
    main()
