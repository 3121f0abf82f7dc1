"""The whole round's share of the bf16 peak, read as ``mfu.lm`` reads it, in the
long-context cells (they report ``long_train_tokens_per_s``)."""
from hflbench.harness import load_module

read = load_module("metrics", "mfu.lm").read
