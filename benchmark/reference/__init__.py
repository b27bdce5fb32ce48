"""A plain PyTorch reference of DeepPhysiNet, independent of the measured program."""
