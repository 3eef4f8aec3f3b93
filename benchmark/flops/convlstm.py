"""The ConvLSTM's conv layers: each layer's 3x3 gate conv over ``cat(x,
h)`` to four gates, once per input step, and the 1x1 head on the last
hidden state."""


def conv_layers(cfg: dict):
    model, data = cfg["model"], cfg["data"]
    n, t = data["grid_n"], data["input_time_steps"]
    cin = len(data["variables"]) + int(data["add_insolation"]) + len(data["constants"])
    layers = []
    for feats in model["filters"]:
        layers.append((n, cin + feats, 4 * feats, 3, t))
        cin = feats
    layers.append((n, cin, model["output_channels"], 1, 1))
    return layers
