"""The DLWP-CS U-Net and the cubed-sphere ConvLSTM as plain functions of a
parameter dict, from the configuration's fields alone.

:func:`param_shapes` lists every parameter by name and HWIO shape; the
benchmark draws the weights for that list and hands the same tensors to
the program (whose module must take them by the same names) and to
:func:`forward`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.ops import avg_pool2, conv, upsample2


def _conv_shapes(prefix, k, cin, cout):
    return {prefix + ".kernel_eq": (k, k, cin, cout), prefix + ".kernel_pole": (k, k, cin, cout),
            prefix + ".bias_eq": (cout,), prefix + ".bias_pole": (cout,)}


def unet_convs(model: dict, in_ch: int):
    """``[(name, size divisor, Cin, Cout, k)]`` of the U-Net's convs in
    call order."""
    f, per = model["filters"], model["convs_per_block"]
    out, cin = [], in_ch

    def block(name, lvl, c0, feats):
        for i in range(per):
            out.append((f"convs.{name}_conv{i}", 2 ** lvl, c0 if i == 0 else feats, feats, 3))

    for lvl, feats in enumerate(f):
        block(f"enc{lvl}", lvl, cin, feats)
        cin = feats
    for lvl in range(len(f) - 2, -1, -1):
        block(f"dec{lvl}", lvl, f[lvl + 1] + f[lvl], f[lvl])
    out.append(("convs.head", 1, f[0], model["output_channels"], 1))
    return out


def convlstm_convs(model: dict, data: dict):
    """``[(name, 1, Cin, Cout, k, steps)]`` of the ConvLSTM's convs: each
    layer's gate conv runs once per input step."""
    t = data["input_time_steps"]
    cin = len(data["variables"]) + (1 if data["add_insolation"] else 0) + len(data["constants"])
    out = []
    for i, feats in enumerate(model["filters"]):
        out.append((f"convlstm{i}.cell.gates", 1, cin + feats, 4 * feats, 3, t))
        cin = feats
    out.append(("head", 1, cin, model["output_channels"], 1, 1))
    return out


def param_shapes(kind: str, model: dict, data: dict, in_ch: int) -> dict:
    convs = unet_convs(model, in_ch) if kind == "unet" else convlstm_convs(model, data)
    shapes = {}
    for c in convs:
        shapes.update(_conv_shapes(c[0], c[4], c[2], c[3]))
    return shapes


def _act(model):
    return lambda x: F.leaky_relu(x, model["activation_slope"])


def unet_forward(p: dict, model: dict, x):
    act, f, per = _act(model), model["filters"], model["convs_per_block"]

    def block(x, name):
        for i in range(per):
            x = act(conv(x, p, f"convs.{name}_conv{i}"))
        return x

    skips = []
    for lvl in range(len(f) - 1):
        x = block(x, f"enc{lvl}")
        skips.append(x)
        x = avg_pool2(x)
    x = block(x, f"enc{len(f) - 1}")
    for lvl in range(len(f) - 2, -1, -1):
        x = block(torch.cat([upsample2(x), skips[lvl]], dim=-1), f"dec{lvl}")
    return conv(x, p, "convs.head")


def convlstm_forward(p: dict, model: dict, data: dict, x):
    t, cv = data["input_time_steps"], len(data["variables"])
    b, _, n, _, _ = x.shape
    steps = [x[..., s * cv:(s + 1) * cv] for s in range(t)]
    if data["add_insolation"]:
        steps = [torch.cat([s, x[..., t * cv + i:t * cv + i + 1]], -1) for i, s in enumerate(steps)]
    k = len(data["constants"])
    if k:
        steps = [torch.cat([s, x[..., x.shape[-1] - k:]], -1) for s in steps]
    nl = len(model["filters"])
    for li, feats in enumerate(model["filters"]):
        h = x.new_zeros(b, 6, n, n, feats)
        c = x.new_zeros(b, 6, n, n, feats)
        outs = []
        for s in steps:
            z = conv(torch.cat([s, h], -1), p, f"convlstm{li}.cell.gates")
            i, fg, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(fg + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        steps = outs if li < nl - 1 else [h]
    return conv(steps[-1], p, "head")


def forward(kind: str, p: dict, model: dict, data: dict, x):
    """The model on the folded input ``(B, 6, n, n, C_in)``."""
    if kind == "unet":
        return unet_forward(p, model, x)
    return convlstm_forward(p, model, data, x)
