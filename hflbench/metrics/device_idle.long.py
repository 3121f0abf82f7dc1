"""The device's idle share, read as ``device_idle.lm`` reads it, in the
long-context cells (they report ``long_train_tokens_per_s``)."""
from hflbench.harness import load_module

read = load_module("metrics", "device_idle.lm").read
