"""Inference / evaluation CLI of the port.

Counterpart of the repo's test.py (reference codes/test.py:21-107 and
test_split.py) for fixed pipelines: whole-frame inference with the
intermediates, PSNR and SSIM per frame and their min/max/mean/std, and with
`patch_size` / `patch_stride` in the dataset options the feathered tiling
of parallel/tiling.py.  `precision: bf16` sets the CNN storage
(precision.py) and `path.pretrain_model_G` loads a network checkpoint of
either package.  A detection model (`model: *yolo*`) scores each output
frame with the frozen YOLOv3 of the `yolo` options in place of PSNR: decode
at the frame's own height, NMS at the dataset's `conf_thres`, the frame's
label boxes, then AP per class; it prints `map=` and keeps each frame's
detections, (D, 7) [x1, y1, x2, y2, conf, cls_conf, cls], as
<stem>_dets.npy.

Images go under path.results_root: the output and the input|intermediates|GT
strip as PNGs (utils/png, no cv2), the files the JAX package writes.  It
runs on the GPU unless `--device cpu` is given, and exits with an error when
CUDA is absent and the CPU was not asked for.  --device replaces the JAX
CLI's --platform.

Usage:
  python -m reconfigisp_tpu_torch.test --opt configs/SID_test.yaml \
      [--max-images N] [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np


def _write(out_dir: str, stem: str, frame: np.ndarray, strip) -> None:
    """The output frame (float, [0, 1]) and the strip, if any, as PNGs."""
    from reconfigisp_tpu_torch.utils import png
    from reconfigisp_tpu_torch.utils.imaging import tensor2bgr
    if strip is not None:
        png.write(os.path.join(out_dir, f"{stem}_strip.png"),
                  tensor2bgr(strip))
    png.write(os.path.join(out_dir, f"{stem}.png"), tensor2bgr(frame))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--opt", required=True)
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from reconfigisp_tpu_torch import config, convert, precision
    from reconfigisp_tpu_torch.data import create_dataset
    from reconfigisp_tpu_torch.parallel.tiling import tiled_apply
    from reconfigisp_tpu_torch.pipeline import Pipeline, resolve_device
    from reconfigisp_tpu_torch.utils import checkpoint
    from reconfigisp_tpu_torch.utils.logging_utils import setup_logger
    from reconfigisp_tpu_torch.utils.metrics import psnr as psnr_fn
    from reconfigisp_tpu_torch.utils.metrics import ssim as ssim_fn

    opt = config.parse(args.opt, is_train=False)
    dev = resolve_device(args.device or opt.get("device"))
    paths = opt["path"]
    logger = setup_logger("base", paths.get("log"), f"test_{opt['name']}")

    net_opt = opt["network_G"]
    pipe = Pipeline(net_opt["architecture"],
                    use_proxy=config.network_uses_proxy(net_opt), device=dev)
    if paths.get("pretrain_model_G"):
        loaded = checkpoint.load_network(paths["pretrain_model_G"])
        pipe.load_state(convert.state_from_jax(loaded))
        logger.info(f"loaded model {paths['pretrain_model_G']}")
    pipe.eval()

    ds_opt = dict(opt["datasets"]["test"] if opt["datasets"].get("test")
                  else opt["datasets"]["train"])
    ds_opt["is_train"] = False
    dataset = create_dataset(ds_opt)

    split = bool(ds_opt.get("patch_size"))
    if split:
        patch = int(ds_opt["patch_size"])
        stride = int(ds_opt.get("patch_stride", patch))

    out_dir = paths.get("results_root")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    is_yolo = "yolo" in (opt["model"] or "")
    if is_yolo:
        from reconfigisp_tpu_torch.search.trainer import build_yolo_evaluator
        from reconfigisp_tpu_torch.yolo import train as ytrain
        detector = build_yolo_evaluator(opt["yolo"], dev)
        conf_thres = ds_opt.get("conf_thres", 0.5) or 0.5
        all_dets, all_gts, all_tcls = [], [], []

    save_strips = bool(ds_opt.get("save_strips", True))
    psnrs, ssims = [], []
    n = len(dataset) if args.max_images is None \
        else min(args.max_images, len(dataset))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode(), precision.cnn_storage(
            str(opt.get("precision") or "f32")):
        for i in range(n):
            sample = dataset[i]
            x = torch.from_numpy(sample["noisy"][None]).to(dev)
            mids = None
            sync()
            t0 = time.perf_counter()
            if split:
                y = tiled_apply(pipe, x, patch=patch, stride=stride)
            else:
                y, mids, _ = pipe(x, return_intermediates=True)
            sync()
            ms = 1e3 * (time.perf_counter() - t0)
            gt = sample.get("gt")
            dets = None
            if is_yolo:
                # decode at the frame fed to the detector: in split mode it
                # can be larger than data_size, and the configured size
                # would mis-scale every box
                frame_h, frame_w = int(y.shape[1]), int(y.shape[2])
                dets = ytrain.detections(detector(y.float().flip(-1)),
                                         frame_h, conf_thres)[0]
                gtb, tcls = ytrain.label_boxes(sample["label"], frame_h,
                                               frame_w)
                all_dets.append(dets)
                all_gts.append(gtb)
                all_tcls.extend(tcls)
                logger.info(f"[{i}] detections {len(dets)} ({ms:.3f} ms)")
            elif gt is not None:
                g = torch.from_numpy(np.asarray(gt, np.float32)[None]).to(dev)
                p = float(psnr_fn(y, g)[0])
                s = float(ssim_fn(y, g)[0])
                psnrs.append(p)
                ssims.append(s)
                logger.info(f"[{i}] psnr {p:.3f} ssim {s:.4f} ({ms:.3f} ms)")
            else:
                logger.info(f"[{i}] ({ms:.3f} ms)")
            if out_dir:
                strip = None
                if save_strips and mids is not None and gt is not None:
                    # input | intermediates | GT (reference test.py:74-99)
                    pieces = [x[0]] + [m[0] for m in mids.values()]
                    pieces = [np.repeat(p.float().cpu().numpy(), 3, axis=2)
                              if p.shape[-1] == 1 else p.float().cpu().numpy()
                              for p in pieces] + [np.asarray(gt)]
                    strip = np.concatenate(pieces, axis=1)
                _write(out_dir, f"{i:04d}", y[0].float().cpu().numpy(), strip)
                if dets is not None:
                    np.save(os.path.join(out_dir, f"{i:04d}_dets.npy"), dets)
    if psnrs:
        arr = np.asarray(psnrs)
        # min/max/mean/std summary (reference test.py:101-107)
        logger.info(f"PSNR min {arr.min():.3f} max {arr.max():.3f} "
                    f"mean {arr.mean():.3f} std {arr.std():.3f}")
        logger.info(f"SSIM mean {np.mean(ssims):.4f}")
        print(f"psnr_mean={arr.mean():.4f}", flush=True)
    if is_yolo:
        out = ytrain.score(all_dets, all_gts, all_tcls)
        if out is None:
            logger.info("no detections above threshold")
            print("map=0.0", flush=True)
        else:
            logger.info(f"mAP {out['mAP']:.4f} P {out['precision'].mean():.3f} "
                        f"R {out['recall'].mean():.3f}")
            print(f"map={out['mAP']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
