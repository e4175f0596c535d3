"""Model zoo (PyTorch nn.Modules, NHWC at the boundaries)."""
