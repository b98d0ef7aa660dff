"""Training / search CLI of the port.

Counterpart of the repo's train.py (reference codes/train.py:58-301 and
train_ft.py): one entry point for models isp, darts, darts_ft, darts_yolo
and isp_yolo, reading the same configs/*.yaml through the port's
config.parse and running search.run_training.  It runs on the GPU unless `--device cpu` is given, and
exits with an error when CUDA is absent and the CPU was not asked for.
--device replaces the JAX CLI's --platform.  Under torchrun (RANK and
WORLD_SIZE set) every rank starts the process group
(parallel/mesh.init_process_group: NCCL where each rank has a card of its
own, gloo on the CPU or where ranks share a card) before run_training, the
counterpart of the JAX CLI's --multihost; a config with `dist: true` then
splits each global batch over the ranks, and rank 0 alone saves, logs and
prints the summary.

Usage:
  python -m reconfigisp_tpu_torch.train --opt configs/SID_isp.yaml \
      [--niter N] [--device cpu]
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m reconfigisp_tpu_torch.train --opt configs/SID_search.yaml
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--opt", required=True, help="path to YAML options")
    parser.add_argument("--niter", type=int, default=None,
                        help="override train.niter")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from reconfigisp_tpu_torch import config
    from reconfigisp_tpu_torch.device import resolve_device
    from reconfigisp_tpu_torch.parallel import mesh
    from reconfigisp_tpu_torch.search.trainer import run_training

    opt = config.parse(args.opt, is_train=True)
    device = args.device or opt.get("device")
    grouped = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if grouped:
        mesh.init_process_group(resolve_device(device))
    main_proc = mesh.is_main_process()
    try:
        summary = run_training(opt, max_iters=args.niter, device=device)
    finally:
        if grouped:
            dist.destroy_process_group()
    if main_proc:
        print("training done:", summary, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
