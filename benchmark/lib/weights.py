"""Seeded weights and logits, made on the device in a few large calls.

Every convolution's weight and bias are uniform in +-sqrt(1 / fan_in)
(torch's Conv2d default), drawn as one uniform vector for all of a cell's
modules and scaled by one per-element bound, then viewed leaf by leaf.  To
that each module without a residual of its own gets an identity path
(`embed_identity`), so that with random weights it still maps an image to
an image near it, as a trained one does, and its outputs do not collapse to
its biases and clip away.  The same tensors go to the program and to the
reference.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import zoo


def draw_modules(gen: torch.Generator, kinds: dict, device,
                 zero_cond: dict | None = None) -> dict:
    """{op: module kind} -> {op: [(weight OIHW, bias)]}.  zero_cond: {op:
    parameter count} of SRCNN-Res proxies whose conditioning columns past
    3 + 9 + count stay zero (their inputs are zero-padded params)."""
    leaves = []   # (op, conv index, shape, bound)
    for op, kind in kinds.items():
        for i, (cin, cout, k) in enumerate(zoo.conv_shapes(kind)):
            bound = math.sqrt(1.0 / (cin * k * k))
            leaves.append((op, i, (cout, cin, k, k), bound))
            leaves.append((op, i, (cout,), bound))
    sizes = [math.prod(shape) for _, _, shape, _ in leaves]
    bounds = torch.repeat_interleave(
        torch.tensor([b for *_, b in leaves], device=device),
        torch.tensor(sizes, device=device))
    flat = (2.0 * torch.rand(sum(sizes), generator=gen, device=device)
            - 1.0) * bounds
    out: dict = {op: [] for op in kinds}
    pieces = iter(torch.split(flat, sizes))
    for (op, _, shape, _), piece in zip(leaves, pieces):
        if len(shape) == 4:
            weight = piece.view(shape)
        else:
            out[op].append((weight, piece))
    for op, n_params in (zero_cond or {}).items():
        out[op][0][0][:, 3 + 9 + n_params:] = 0.0
    for op, kind in kinds.items():
        embed_identity(kind, out[op])
    return out


# the packed RGGB plane each output colour (B, G, R) copies at every site
_NEAREST_PLANE = (3, 1, 0)


def embed_identity(kind: str, convs: list) -> None:
    """Add 1 at the centre tap of an identity path, in place: for
    Path-Restore the input channels through the first conv and the last (the
    residual blocks stay random); for the SRCNN demosaic the four planes
    through the first two convs and, in the last, each colour at each of the
    four sites from its nearest plane (a nearest-neighbour demosaic).  The
    inputs are images in [0, 1], so the ReLUs pass the path."""
    if kind in ("path_bayer", "path_bgr"):
        first, last = convs[0][0], convs[-1][0]
        for c in range(first.shape[1]):
            first[c, c, 1, 1] += 1.0
        for c in range(last.shape[0]):
            last[c, c, 1, 1] += 1.0
    elif kind == "srcnn_demosaic":
        w1, w2, w3 = (convs[i][0] for i in range(3))
        for k in range(4):
            w1[k, k, 4, 4] += 1.0
            w2[k, k, 0, 0] += 1.0
        for c, plane in enumerate(_NEAREST_PLANE):
            for site in range(4):
                w3[4 * c + site, plane, 2, 2] += 1.0


def program_state_dict(kind: str, convs: list) -> dict:
    """The module's state_dict in the program's names (ops/cnn.py:
    PathRestore14's conv_first, blocks.i.conv1/2, conv_last; SRCNN's
    conv1..3)."""
    if kind in ("path_bayer", "path_bgr"):
        names = (["conv_first"]
                 + [f"blocks.{b}.conv{j}" for b in range(6) for j in (1, 2)]
                 + ["conv_last"])
    else:
        names = ["conv1", "conv2", "conv3"]
    sd = {}
    for name, (w, b) in zip(names, convs):
        sd[f"{name}.weight"] = w
        sd[f"{name}.bias"] = b
    return sd


def logits_near(gen: torch.Generator, init: tuple, spread: float, device):
    """An op's initial logits moved by N(0, spread^2) each."""
    base = torch.tensor(init, dtype=torch.float32, device=device)
    return base + spread * torch.randn(base.shape, generator=gen,
                                       device=device)
