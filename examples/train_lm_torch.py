"""Train a ~1M-param reduced LM end to end with the PyTorch port.

Exercises the training substrate: init, the train step (loss, backward,
AdamW), checkpoint/restart and fault injection, on the card by default or
on the CPU with ``--device cpu``.

    python examples/train_lm_torch.py --device cpu --steps 200
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_example"))
    args = ap.parse_args(argv)
    loss = train_main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--lr", "3e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--device", args.device,
    ])
    print(f"final loss: {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
