"""Training / search CLI of the port.

Counterpart of the repo's train.py (reference codes/train.py:58-301 and
train_ft.py): one entry point for models isp, darts, darts_ft, darts_yolo
and isp_yolo, reading the same configs/*.yaml through the port's
config.parse and running search.run_training.  It runs on the GPU unless `--device cpu` is given, and
exits with an error when CUDA is absent and the CPU was not asked for.  The
JAX CLI's --platform (choose a JAX backend) and --multihost (start
jax.distributed) have no counterpart here: --device replaces the first, and
data parallelism is not ported yet (ROADMAP.md, the item on
parallel/mesh.py and parallel/dp.py).

Usage:
  python -m reconfigisp_tpu_torch.train --opt configs/SID_isp.yaml \
      [--niter N] [--device cpu]
"""

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--opt", required=True, help="path to YAML options")
    parser.add_argument("--niter", type=int, default=None,
                        help="override train.niter")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from reconfigisp_tpu_torch import config
    from reconfigisp_tpu_torch.search.trainer import run_training

    opt = config.parse(args.opt, is_train=True)
    summary = run_training(opt, max_iters=args.niter, device=args.device)
    print("training done:", summary, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
