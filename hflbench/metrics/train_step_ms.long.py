"""The cluster train step's mean time, read as ``train_step_ms.lm`` reads it, in the
long-context cells (they report ``long_train_tokens_per_s``)."""
from hflbench.harness import load_module

read = load_module("metrics", "train_step_ms.lm").read
