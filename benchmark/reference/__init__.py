"""The plain reference that decides ``correct``: the cubed-sphere padding,
the U-Net, the ConvLSTM, insolation, normalisation, the rollout, the
ensemble mean and spread, in plain PyTorch.  It imports nothing of the
program under test."""
