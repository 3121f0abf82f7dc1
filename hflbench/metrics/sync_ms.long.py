"""The flat sparse sync's mean time, read as ``sync_ms.lm`` reads it, in the
long-context cells (they report ``long_train_tokens_per_s``)."""
from hflbench.harness import load_module

read = load_module("metrics", "sync_ms.lm").read
