"""Serving for fixed ISP pipelines: make_serving_fn and the serving artifact.

Counterpart of reconfigisp_tpu/deploy.py.  A trained pipeline exports to a
self-contained artifact (`export_pipeline`), a `torch.export` program in
place of the JAX package's StableHLO:

  * weights and op parameters are baked into the program, so loading needs
    neither the op zoo nor the original weights: `load_pipeline` imports
    this module and the kernels' custom ops (ops/kernels/, which the
    program calls as `reconfigisp::bilateral`, `::median` and `::fastnlm`),
    and nothing of registry.py or pipeline.py;
  * the program is make_serving_fn's: whole-frame, or the feathered tiled
    engine (parallel/tiling.py) for 12 MP-class frames;
  * the CNN storage policy (precision.py) is applied at export trace time
    and recorded in the header;
  * the program runs on the card (the kernels) or on the CPU (their plain
    forms); `load_pipeline` moves it to the device it is asked for, cuda
    unless the caller names the CPU;
  * a mesh artifact (`data_parallel=d`, `space_parallel=s`, whole-frame)
    holds the program of one rank's share: N / d images of the served
    batch and, for s > 1, the common window height of the space axis
    (parallel/space.py: the owned rows and the pipeline's row radius on
    each side), with the global ops' reductions as the custom ops
    reconfigisp::space_sum and ::space_rows; loaded in a process group of
    at least d s ranks (parallel/mesh.py), each rank runs its window under
    the space context, keeps its owned rows, and the output is gathered
    over space and then over data back to the whole batch.

Artifact layout: the magic MAGIC (the JAX package's is RISPTPU1, so each
loader refuses the other's artifact), uint32 little-endian header length, a
UTF-8 JSON header with the JAX package's keys (version, architecture,
use_proxy, input_shape, dtype, patch, stride, chunk, cnn_storage, mesh,
platforms; a space-parallel artifact adds halo, the pipeline's row
radius), then the torch.export.save bytes.
"""

from __future__ import annotations

import contextlib
import io
import json
import struct
from typing import Optional, Sequence, Union

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from reconfigisp_tpu_torch import precision
from reconfigisp_tpu_torch.device import resolve_device
# the custom ops a serving program calls, registered on import
from reconfigisp_tpu_torch.ops.kernels import bilateral, fastnlm, median  # noqa: F401
from reconfigisp_tpu_torch.parallel import mesh as meshlib
from reconfigisp_tpu_torch.parallel import space as spacelib
from reconfigisp_tpu_torch.parallel.tiling import tiled_apply
from reconfigisp_tpu_torch.utils import tracing

MAGIC = b"RISPTOR1"
_VERSION = 1
_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


class ServingProgram(nn.Module):
    """mosaic -> sRGB: the pipeline on the whole frame, or with `patch` set
    through the feathered tiled engine; `stride` defaults to patch (no
    overlap) and `chunk` is the number of tile positions per pipeline
    call."""

    def __init__(self, pipe, patch: Optional[int] = None,
                 stride: Optional[int] = None, chunk: int = 32):
        super().__init__()
        self.pipe = pipe
        self.patch = int(patch) if patch else None
        self.stride = int(stride or patch or 0)
        self.chunk = chunk

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.patch:
            return tiled_apply(self.pipe, x, patch=self.patch,
                               stride=self.stride, chunk=self.chunk)
        return self.pipe(x)


def make_serving_fn(pipe, *, patch: Optional[int] = None,
                    stride: Optional[int] = None, chunk: int = 32,
                    device=None):
    """mosaic -> sRGB closure over the pipeline's ServingProgram, run in
    inference mode.  `device` defaults to cuda and must be the pipeline's;
    inputs are moved to it.  Each call is the root span `serve.frame`
    (utils/tracing.py)."""
    dev = resolve_device(device)
    if pipe.device != dev:
        raise ValueError(f"pipeline is on {pipe.device}, serving on {dev}")
    program = ServingProgram(pipe, patch, stride, chunk)

    @torch.inference_mode()
    def serve(x) -> torch.Tensor:
        with tracing.span("serve.frame"):
            return program(torch.as_tensor(x, dtype=torch.float32,
                                           device=dev))

    return serve


def _check_mesh(data: int, space: int):
    """A (data x space) mesh baked into an artifact over a process group
    of at least data x space ranks (the JAX package's check, a rank for a
    device) -> the mesh."""
    have = meshlib.world_size()
    if have < data * space:
        raise ValueError(f"mesh data={data} x space={space} needs "
                         f"{data * space} devices, have {have}")
    return meshlib.make_mesh(data * space, space=space)


def _platform_names(platforms: Optional[Sequence[str]]) -> list:
    if platforms is None:
        return ["cuda", "cpu"]
    names = []
    for name in platforms:
        if name.lower() not in _PLATFORMS:
            raise ValueError(f"platform {name!r}: the port serves on "
                             f"{sorted(_PLATFORMS)}")
        if _PLATFORMS[name.lower()] not in names:
            names.append(_PLATFORMS[name.lower()])
    return names


def export_pipeline(pipe, input_shape: Sequence, *,
                    patch: Optional[int] = None,
                    stride: Optional[int] = None,
                    chunk: int = 32,
                    storage: Optional[str] = None,
                    data_parallel: int = 1,
                    space_parallel: int = 1,
                    platforms: Optional[Sequence[str]] = None) -> bytes:
    """Export `pipe` (a Pipeline, with its state) as a serving artifact.

    input_shape: (N, H, W, C) of the serving request; one artifact per
    served shape.  For the whole-frame path N may be -1 or "b": the batch is
    exported symbolic (torch.export.Dim) and one artifact serves any batch
    size; the tiled engine needs a concrete batch.  The trace runs on the
    pipeline's device.  storage: CNN storage applied at trace time ('f32' or
    'bf16'; None = the active policy).  data_parallel = d and
    space_parallel = s, not both 1 (whole-frame), record the mesh
    {"data": d, "space": s} and export the program of one rank's share:
    N / d images and, for s > 1, the space axis's common window height for
    the pipeline's row radius (parallel/space.py), traced under a one-rank
    space context so that the global ops' reductions are custom ops of the
    program; it needs no process group here, and the loader needs one of
    d s ranks.  platforms: where the artifact may be loaded,
    'cuda' (or 'gpu') and 'cpu'; None = both, since the program runs on
    either device.  Recorded in the header; load_pipeline holds to it."""
    mesh_dims = (int(data_parallel), int(space_parallel))
    if mesh_dims != (1, 1):
        if patch:
            raise ValueError("mesh-sharded export is whole-frame only; the "
                             "tiled engine is the single-chip memory story")
    names = _platform_names(platforms)
    dims = list(input_shape)
    poly_batch = dims[0] in (-1, "b", None)
    if poly_batch and patch:
        raise ValueError("symbolic batch is whole-frame only; the tiled "
                         "engine needs a concrete batch size")
    rows = 2 if poly_batch else int(dims[0])
    if not poly_batch:
        # one rank's rows; raises as a NamedSharding does if d does not
        # divide the batch
        rows = meshlib.shard_slices((rows,), 0, mesh_dims[0], 0, 1)[0]
        rows = rows.stop - rows.start
    frame = [int(d) for d in dims[1:]]
    halo = None
    traced = contextlib.nullcontext()
    if mesh_dims[1] > 1:
        halo = spacelib.radius(pipe)
        height = frame[0]
        win = spacelib.window(height, 0, mesh_dims[1], halo)
        frame[0] = win.rows
        traced = spacelib.context(None, win, height)
    example = torch.zeros((rows, *frame), device=pipe.device)
    dynamic = ({0: torch.export.Dim("b")},) if poly_batch else None
    program = ServingProgram(pipe, patch, stride, chunk)
    dtype = (precision._DTYPES[storage] if storage
             else precision.cnn_storage_dtype())
    with precision.cnn_storage(dtype), torch.no_grad(), traced:
        exported = torch.export.export(program, (example,),
                                       dynamic_shapes=dynamic, strict=False)
    # the example input would be saved with the program: a zero frame
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    header = {
        "version": _VERSION,
        "architecture": pipe.architecture,
        "use_proxy": pipe.use_proxy,
        "input_shape": ["b" if poly_batch else int(dims[0])]
                       + [int(d) for d in dims[1:]],
        "dtype": "float32",
        "patch": int(patch) if patch else None,
        "stride": int(stride or patch) if patch else None,
        "chunk": int(chunk) if patch else None,
        "cnn_storage": str(dtype).removeprefix("torch."),
        "mesh": ({"data": mesh_dims[0], "space": mesh_dims[1]}
                 if mesh_dims != (1, 1) else None),
        "platforms": names,
    }
    if halo is not None:
        header["halo"] = halo
    hjson = json.dumps(header).encode("utf-8")
    return MAGIC + struct.pack("<I", len(hjson)) + hjson + buf.getvalue()


def save_artifact(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


class ServingPipeline:
    """A loaded artifact: `meta` dict + `__call__(image) -> sRGB` on
    `device`.  The program holds the weights; no op zoo is needed.  A
    mesh artifact is served by every rank of its mesh, each called with
    the whole batch: it runs its images (on a space axis, its window of
    their frames under the space context, then keeps the owned rows) and
    returns the whole output, gathered over space and data in rank
    order."""

    def __init__(self, meta: dict, exported, device: torch.device):
        self.meta = meta
        self.device = device
        self._exported = exported
        self._module = exported.module()
        self._mesh = (_check_mesh(meta["mesh"]["data"], meta["mesh"]["space"])
                      if meta.get("mesh") else None)
        self._space = spacelib.SpaceAxis.of(self._mesh, meta.get("halo"))

    @property
    def architecture(self) -> str:
        return self.meta["architecture"]

    @property
    def input_shape(self):
        return tuple(self.meta["input_shape"])

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        want = self.input_shape
        if x.ndim != len(want) or any(
                d != "b" and s != d for s, d in zip(x.shape, want)):
            raise ValueError(f"artifact serves {list(want)}, got "
                             f"{list(x.shape)}")
        with torch.inference_mode():
            if self._mesh is None:
                return self._module(x)
            x = meshlib.shard_data(self._mesh, x)
            if self._space is None:
                y = self._module(x)
            else:
                with self._space.frame(x.shape[1]):
                    y = spacelib.gather(self._module(self._space.take(x)))
            return meshlib.all_gather(
                y, self._mesh.get_group(meshlib.DATA_AXIS))


def split_artifact(blob: bytes):
    """-> (header dict, torch.export.save bytes); raises ValueError on
    another magic (the JAX package's artifact among them) or version."""
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError(f"not a reconfigisp_tpu_torch serving artifact "
                         f"(magic {blob[:8]!r})")
    off = len(MAGIC)
    (hlen,) = struct.unpack("<I", blob[off:off + 4])
    off += 4
    meta = json.loads(blob[off:off + hlen].decode("utf-8"))
    if meta.get("version") != _VERSION:
        raise ValueError(f"unsupported artifact version {meta.get('version')}")
    return meta, blob[off + hlen:]


def load_pipeline(src: Union[str, bytes], device=None) -> ServingPipeline:
    """Load an artifact from a path or raw bytes onto `device` (cuda unless
    the caller names the CPU); a program exported on the other device is
    moved (torch.export.passes.move_to_device_pass)."""
    blob = src
    if isinstance(src, str):
        with open(src, "rb") as f:
            blob = f.read()
    meta, program = split_artifact(blob)
    dev = resolve_device(device)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"artifact exported for {meta['platforms']}, "
                         f"not {dev.type}")
    exported = move_to_device_pass(torch.export.load(io.BytesIO(program)),
                                   dev)
    return ServingPipeline(meta, exported, dev)
