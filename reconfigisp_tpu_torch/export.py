"""Export CLI of the port: a trained fixed pipeline as a serving artifact.

Counterpart of the repo's tools/export_pipeline.py.  It reads the same
config surface as the test CLI (network_G.architecture and
path.pretrain_model_G, a network checkpoint of either package), bakes the
weights into a torch.export program (deploy.export_pipeline) and writes one
artifact per served shape.  The tiling defaults come from the test set's
patch_size / patch_stride.  The trace runs on the GPU unless `--device cpu`
is given (--device replaces the JAX CLI's --platform); the artifact loads
on the devices --platforms names, both by default.

Usage:
  python -m reconfigisp_tpu_torch.export --opt configs/SID_test.yaml \
      --shape 1x2848x4256x1 --patch 512 --stride 480 --storage bf16 \
      --out sid_serving.rispt [--device cpu]
  python -m reconfigisp_tpu_torch.export --opt configs/SID_test.yaml \
      --shape 2x2848x4256x1 --patch 0 --data-parallel 1 --space-parallel 2 \
      --out sid_space2.rispt    # served by 2 ranks, each half of a frame
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--opt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--shape", required=True,
                    help="NxHxWxC of the serving request, e.g. 1x2848x4256x1"
                         " (N may be 'b' for a symbolic batch, whole-frame"
                         " path only)")
    ap.add_argument("--patch", type=int, default=None)
    ap.add_argument("--stride", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--storage", default=None, choices=[None, "f32", "bf16"])
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="mesh 'data' axis: the ranks that serve the batch"
                         " (whole-frame path only)")
    ap.add_argument("--space-parallel", type=int, default=1,
                    help="mesh 'space' axis: the ranks that split each"
                         " frame's height, each running a window with the"
                         " pipeline's halo (whole-frame path only)")
    ap.add_argument("--platforms", default=None,
                    help="comma list of cuda (or gpu) and cpu: where the "
                         "artifact may be loaded; both by default")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: where the trace runs")
    args = ap.parse_args(argv)

    from reconfigisp_tpu_torch import config, convert, deploy
    from reconfigisp_tpu_torch.pipeline import Pipeline, resolve_device
    from reconfigisp_tpu_torch.utils import checkpoint

    opt = config.parse(args.opt, is_train=False)
    dev = resolve_device(args.device or opt.get("device"))
    net_opt = opt["network_G"]
    pipe = Pipeline(net_opt["architecture"],
                    use_proxy=config.network_uses_proxy(net_opt), device=dev)
    pre = opt["path"].get("pretrain_model_G")
    if pre:
        pipe.load_state(convert.state_from_jax(checkpoint.load_network(pre)))
        print(f"loaded {pre}")
    else:
        print("WARNING: no path.pretrain_model_G — exporting init weights")

    shape = tuple("b" if d == "b" else int(d)
                  for d in args.shape.lower().split("x"))
    # tiling defaults from the config's test-set split settings
    ds = opt["datasets"].get("test") or {}
    patch = args.patch if args.patch is not None else ds.get("patch_size")
    stride = args.stride if args.stride is not None \
        else ds.get("patch_stride")
    platforms = args.platforms.split(",") if args.platforms else None

    blob = deploy.export_pipeline(
        pipe, shape, patch=patch, stride=stride, chunk=args.chunk,
        storage=args.storage, data_parallel=args.data_parallel,
        space_parallel=args.space_parallel, platforms=platforms)
    deploy.save_artifact(args.out, blob)
    print(f"wrote {args.out}: {len(blob) / 1e6:.2f} MB, "
          f"arch {pipe.architecture}, shape {shape}, "
          f"patch {patch}/{stride}, platforms "
          f"{deploy.split_artifact(blob)[0]['platforms']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
