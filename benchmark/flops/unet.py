"""The U-Net's conv layers: two 3x3 convs a block down the levels (the
face size halving), two up them with the skip concatenated, and the 1x1
head."""


def conv_layers(cfg: dict):
    model, n = cfg["model"], cfg["data"]["grid_n"]
    f, per = model["filters"], model["convs_per_block"]
    layers, cin = [], cfg["input_channels"]
    for lvl, feats in enumerate(f):
        for i in range(per):
            layers.append((n >> lvl, cin if i == 0 else feats, feats, 3, 1))
        cin = feats
    for lvl in range(len(f) - 2, -1, -1):
        for i in range(per):
            layers.append((n >> lvl, f[lvl + 1] + f[lvl] if i == 0 else f[lvl], f[lvl], 3, 1))
    layers.append((n, f[0], model["output_channels"], 1, 1))
    return layers
