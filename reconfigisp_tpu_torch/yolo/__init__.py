"""The frozen YOLOv3 evaluator: graph, darknet weights, detection loss,
NMS and mAP, and detector pretraining (counterpart of reconfigisp_tpu/yolo).
The convolutions are cuDNN convs through torch, in f32; no kernel of the
port's own is on this path."""
