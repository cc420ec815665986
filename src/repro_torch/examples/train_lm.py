"""End-to-end LM training with the CholeskyPrecond optimizer (PyTorch
port): the reduced llama3.2 config on the card (``--device cpu`` for the
CPU), through ``launch.train.main``. The loss must fall.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
      [--ckpt-dir DIR] [--device cpu|cuda]

Without ``--ckpt-dir`` each run checkpoints into a new directory under
``$TMPDIR``; give the same ``--ckpt-dir`` again to resume a run.
"""
import argparse

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--optimizer", default="cholesky_precond")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new one under "
                         "$TMPDIR)")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default cuda)")
    args = ap.parse_args(argv)
    cmd = ["--arch", args.arch, "--steps", str(args.steps),
           "--optimizer", args.optimizer, "--batch", "8", "--seq", "128"]
    if args.ckpt_dir:
        cmd += ["--ckpt-dir", args.ckpt_dir]
    if args.device:
        cmd += ["--device", args.device]
    losses = train_main(cmd)
    if losses:
        assert losses[-1] < losses[0], "loss must decrease"
        print("OK: loss decreased", losses[0], "->", losses[-1])
    return losses


if __name__ == "__main__":
    main()
