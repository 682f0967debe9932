"""Does torch's first CPU evaluation of the focal loss in a fresh process
agree with its second? The inputs of tests/test_torch_ops.py's focal test
(256 x 80, alpha 0.25, gamma 2), in `--procs` fresh processes, each run
twice (the sigmoid, the per-element cross-entropy `_bce_with_logits`, the
focal loss and its autograd gradient), while `--load` processes keep every
core busy with torch matmuls. Prints the count of processes whose two runs differ and, for
each, the share of elements that moved, the share beyond rtol 1e-5 /
atol 1e-7 and the largest relative move. CPU only.

    python3 port_tools/focal_first_call.py --procs 30 --load 12 --threads 0   # torch's default count
    python3 port_tools/focal_first_call.py --procs 30 --load 12 --threads 1
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import sys
import numpy as np
import torch
if int(sys.argv[1]):
    torch.set_num_threads(int(sys.argv[1]))
from ubteacher_tpu_torch.ops import losses as TL
rng = np.random.default_rng(1)
x = (rng.normal(size=(256, 80)) * 3).astype(np.float32)
t = (rng.random((256, 80)) < 0.05).astype(np.float32)
g = rng.random((256, 80)).astype(np.float32)
def run():
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    T = torch.from_numpy(t)
    p = torch.sigmoid(xt.detach())
    ce = TL._bce_with_logits(xt.detach(), T)
    f = TL.sigmoid_focal_loss(xt, T, 0.25, 2.0)
    (f * torch.from_numpy(g)).sum().backward()
    return {"sigmoid": p.numpy(), "ce": ce.numpy(), "focal": f.detach().numpy(), "grad": xt.grad.numpy()}
a, b = run(), run()
for k in a:
    d = np.abs(a[k] - b[k])
    if d.any():
        rel = d / np.maximum(np.abs(b[k]), 1e-30)
        print(f"{k}: moved {(d > 0).mean():.4f}, beyond tolerance {(d > 1e-7 + 1e-5 * np.abs(b[k])).mean():.4f}, "
              f"max rel {rel.max():.3g}")
"""

BURN = "import torch, time\na = torch.randn(1024, 1024)\nwhile True:\n    a = (a @ a).clamp(-1, 1)\n"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=30)
    ap.add_argument("--load", type=int, default=12, help="busy processes beside the probe")
    ap.add_argument("--threads", type=int, default=0, help="torch threads in the probe, 0: torch's default")
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH=ROOT)
    burners = [subprocess.Popen([sys.executable, "-c", BURN], stdout=subprocess.DEVNULL) for _ in range(args.load)]
    try:
        time.sleep(2)
        odd = 0
        for _ in range(args.procs):
            out = subprocess.run([sys.executable, "-c", CHILD, str(args.threads)], env=env, capture_output=True,
                                 text=True, check=True).stdout
            if out:
                odd += 1
                print(out.strip(), flush=True)
    finally:
        for p in burners:
            p.kill()
            p.wait()
    print(f"threads {args.threads or 'default'}, load {args.load}: {odd} of {args.procs} processes' first run "
          "differs from their second")
    return 0


if __name__ == "__main__":
    sys.exit(main())
