"""YOLOv3 architecture description + darknet cfg parser.

The port's own copy of reconfigisp_tpu/yolo/cfg.py (reference
codes/models/modules/yolo_v3_net.py:239-269 with yolo_v3.cfg, the standard
public YOLOv3 config): `yolov3_blocks()` emits the 75-conv/23-shortcut/
4-route/2-upsample/3-head block sequence, so official darknet weight files
load positionally, and `parse_cfg()` accepts user cfg files.  The block
lists are the JAX package's, dict for dict.
"""

from __future__ import annotations

from typing import List

YOLOV3_ANCHORS = [(10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                  (59, 119), (116, 90), (156, 198), (373, 326)]


def _conv(filters, size, stride=1, bn=True, act="leaky"):
    return {"type": "convolutional", "filters": filters, "size": size,
            "stride": stride, "pad": 1, "batch_normalize": bn,
            "activation": act}


def yolov3_blocks(num_classes: int = 80) -> List[dict]:
    """Standard YOLOv3: Darknet-53 backbone + FPN-style 3-scale heads."""
    out_f = 3 * (5 + num_classes)
    b: List[dict] = []

    def res_stage(filters, n):
        b.append(_conv(filters, 3, stride=2))
        for _ in range(n):
            b.append(_conv(filters // 2, 1))
            b.append(_conv(filters, 3))
            b.append({"type": "shortcut", "from": -3, "activation": "linear"})

    b.append(_conv(32, 3))
    res_stage(64, 1)
    res_stage(128, 2)
    res_stage(256, 8)     # ends at index 36 (route point)
    res_stage(512, 8)     # ends at index 61 (route point)
    res_stage(1024, 4)

    def head(f):
        b.append(_conv(f, 1))
        b.append(_conv(f * 2, 3))
        b.append(_conv(f, 1))
        b.append(_conv(f * 2, 3))
        b.append(_conv(f, 1))
        b.append(_conv(f * 2, 3))
        b.append(_conv(out_f, 1, bn=False, act="linear"))

    head(512)
    b.append({"type": "yolo", "mask": [6, 7, 8], "anchors": YOLOV3_ANCHORS,
              "classes": num_classes})
    b.append({"type": "route", "layers": [-4]})
    b.append(_conv(256, 1))
    b.append({"type": "upsample", "stride": 2})
    b.append({"type": "route", "layers": [-1, 61]})
    head(256)
    b.append({"type": "yolo", "mask": [3, 4, 5], "anchors": YOLOV3_ANCHORS,
              "classes": num_classes})
    b.append({"type": "route", "layers": [-4]})
    b.append(_conv(128, 1))
    b.append({"type": "upsample", "stride": 2})
    b.append({"type": "route", "layers": [-1, 36]})
    head(128)
    b.append({"type": "yolo", "mask": [0, 1, 2], "anchors": YOLOV3_ANCHORS,
              "classes": num_classes})
    return b


def yolov3_tiny_test_blocks(num_classes: int = 1, channels: int = 16) -> List[dict]:
    """A miniature 2-scale graph with the same block types, for tests."""
    out_f = 3 * (5 + num_classes)
    anchors = [(8, 8), (16, 16), (32, 32), (12, 12), (24, 24), (48, 48)]
    b = [
        _conv(channels, 3),
        _conv(channels * 2, 3, stride=2),
        _conv(channels, 1),
        _conv(channels * 2, 3),
        {"type": "shortcut", "from": -3, "activation": "linear"},
        _conv(channels * 4, 3, stride=2),
        _conv(out_f, 1, bn=False, act="linear"),
        {"type": "yolo", "mask": [3, 4, 5], "anchors": anchors,
         "classes": num_classes},
        {"type": "route", "layers": [-3]},
        _conv(channels, 1),
        {"type": "upsample", "stride": 2},
        {"type": "route", "layers": [-1, 4]},
        _conv(out_f, 1, bn=False, act="linear"),
        {"type": "yolo", "mask": [0, 1, 2], "anchors": anchors,
         "classes": num_classes},
    ]
    return b


def parse_cfg(path: str) -> List[dict]:
    """Parse a darknet .cfg file into the same block-dict format
    (reference yolo_v3_net.py:17-60 equivalent)."""
    blocks: List[dict] = []
    current = None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                if current is not None and current["type"] != "net":
                    blocks.append(current)
                current = {"type": line[1:-1].strip()}
                continue
            k, _, v = line.partition("=")
            k, v = k.strip(), v.strip()
            if current is None:
                continue
            if k == "anchors":
                nums = [int(float(t)) for t in v.replace(" ", "").split(",")]
                current[k] = list(zip(nums[0::2], nums[1::2]))
            elif k in ("mask", "layers"):
                current[k] = [int(t) for t in v.split(",")]
            elif k == "from":
                current[k] = int(v)
            elif k in ("filters", "size", "stride", "pad", "batch_normalize",
                       "classes", "num"):
                current[k] = int(v)
            elif k == "activation":
                current[k] = v
            else:
                current[k] = v
    if current is not None and current["type"] != "net":
        blocks.append(current)
    return blocks
